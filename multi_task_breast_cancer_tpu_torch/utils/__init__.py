"""Run bookkeeping of the port: logging, seeding and result sheets
(:mod:`.miscellany`), the XLSX writer (:mod:`.xlsx`), evolution plots
(:mod:`.visualization`) and tracing hooks (:mod:`.profiling`)."""
