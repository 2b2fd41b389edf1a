"""The benchmark's own machinery: finding a cell's files by name, the
measured window, the trace reader, the roofline yardstick and the cohort
generators. Nothing here imports the JAX package or JAX; the program
under test (`bigsnpr_tpu_torch`) is imported only by the job files."""
