"""Several devices: the (samples x variants) mesh of the genotype operator
(`mesh.py`) and the multi-process layer on torch.distributed
(`distributed.py`); port of `bigsnpr_tpu/parallel/`."""
