"""Genotype code tables.

The canonical on-device format is the PLINK .bed 2-bit packing itself
(reference keeps a byte-per-genotype FBM instead; we are 4x denser).
The 2-bit code c in {0,1,2,3} decodes to allele counts via
NUM = {0: 2, 1: NA, 2: 1, 3: 0}  (reference src/bed-acc.h:24).

Within one byte, genotype i occupies bits (2*(i%4), low bits first)
(reference src/bed-acc.h:28-34, 71-75).

The byte-coded FBM.code256 tables of the JAX package's DosagePack come
with the slice that ports it.
"""

import numpy as np

# allele-count value of each 2-bit code; index 1 is missing.
# reference src/bed-acc.h:24: num = {2, NA, 1, 0}
BED_CODE_NUM = np.array([2.0, np.nan, 1.0, 0.0])

# inverse: allele count -> 2-bit code (NA -> code 1)
COUNT_TO_BED_CODE = {2: 0, 1: 2, 0: 3}
