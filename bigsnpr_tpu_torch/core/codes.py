"""Genotype code tables.

The canonical on-device format is the PLINK .bed 2-bit packing itself
(reference keeps a byte-per-genotype FBM instead; we are 4x denser).
The 2-bit code c in {0,1,2,3} decodes to allele counts via
NUM = {0: 2, 1: NA, 2: 1, 3: 0}  (reference src/bed-acc.h:24).

Within one byte, genotype i occupies bits (2*(i%4), low bits first)
(reference src/bed-acc.h:28-34, 71-75).

For dosage data (BGEN) a `DosagePack` keeps a byte per genotype and a
256-entry decode table, mirroring FBM.code256 semantics
(reference R/bigSNP-class.R:7-13); the tables are the JAX package's.
"""

import numpy as np

# allele-count value of each 2-bit code; index 1 is missing.
# reference src/bed-acc.h:24: num = {2, NA, 1, 0}
BED_CODE_NUM = np.array([2.0, np.nan, 1.0, 0.0])

# inverse: allele count -> 2-bit code (NA -> code 1)
COUNT_TO_BED_CODE = {2: 0, 1: 2, 0: 3}

# FBM.code256 tables (reference R/bigSNP-class.R:7-13)
CODE_012 = np.r_[np.array([0.0, 1.0, 2.0]), np.full(253, np.nan)]

CODE_DOSAGE = np.r_[
    np.array([0.0, 1.0, 2.0, np.nan, 0.0, 1.0, 2.0]),
    np.round(np.arange(0, 201) * 0.01, 2),
    np.full(48, np.nan),
]

# imputed views (reference R/impute.R:3-9): raw codes 4..6 hold imputed
# hard calls 0..2, 7+ hold rounded dosages
CODE_IMPUTE_PRED = np.r_[
    np.array([0.0, 1.0, 2.0, np.nan, 0.0, 1.0, 2.0]), np.full(249, np.nan)
]
