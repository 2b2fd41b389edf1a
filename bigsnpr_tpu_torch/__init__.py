"""bigsnpr_tpu_torch — the PyTorch / CUDA port of bigsnpr_tpu.

A second package beside the JAX one, ported slice by slice. This slice
carries the genotype-operator path: PLINK .bed ingest -> scaling ->
randomized SVD -> phenotype simulation -> GWAS -> C+T scores, with the
fused 2-bit decode + GEMM running as hand-written CUDA kernels on the
card (`ops/geno_kernels.py`, `csrc/geno_gemm.cu`).

Entry points run on the CUDA device unless the caller asks for the CPU
(`config.set_device("cpu")` or `device="cpu"`). The package imports
torch, numpy and scipy, and nothing of the JAX package.
"""

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core.genotypes import GenoPack, snp_fake, snp_subset
from bigsnpr_tpu_torch.io.bed import (
    read_bed,
    bed,
    snp_readBed,
    snp_readBed2,
    snp_writeBed,
)
from bigsnpr_tpu_torch.ops.stats import (
    snp_colstats,
    snp_counts,
    bed_counts,
    snp_MAF,
    bed_MAF,
    snp_scaleBinom,
    bed_scaleBinom,
    as_scaling_fun,
)
from bigsnpr_tpu_torch.ops.geno_kernels import GenoOperator
from bigsnpr_tpu_torch.ops.matvec import (
    TorchOperator,
    snp_prodVec,
    snp_cprodVec,
    bed_prodVec,
    bed_cprodVec,
)
from bigsnpr_tpu_torch.linalg.randomsvd import snp_randomSVD, bed_randomSVD, BigSVD
from bigsnpr_tpu_torch.assoc.simu import snp_simuPheno
from bigsnpr_tpu_torch.assoc.gwas import big_univLinReg, big_univLogReg, gwas_pvalues
from bigsnpr_tpu_torch.pgs.prs import snp_PRS, snp_thr_correct

__version__ = "0.1.0"
