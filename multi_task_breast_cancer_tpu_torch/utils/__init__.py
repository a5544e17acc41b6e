"""Run bookkeeping of the port: logging, seeding and result sheets
(:mod:`.miscellany`), the XLSX writer (:mod:`.xlsx`), evolution plots
(:mod:`.visualization`), tracing hooks (:mod:`.profiling`) and leafwise maps
over nested outputs (:mod:`.trees`)."""
