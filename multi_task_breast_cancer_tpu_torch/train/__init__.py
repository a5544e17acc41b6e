"""Training of the port: optimizers and schedulers (:mod:`.optim`), the train
state (:mod:`.state`) and the epoch Engine (:mod:`.loop`)."""
