"""The plain references that decide `correct`: torch, numpy and scipy
only. Nothing here imports the program under test (`bigsnpr_tpu_torch`),
the JAX package or JAX, or takes anything the program made."""
