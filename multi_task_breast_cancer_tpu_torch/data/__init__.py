"""Data of the port: the in-memory fold (:mod:`.dataset`) and the exact joint
augmentation (:mod:`.augment`)."""
