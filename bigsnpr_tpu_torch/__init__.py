"""bigsnpr_tpu_torch — the PyTorch / CUDA port of bigsnpr_tpu.

A second package beside the JAX one, ported slice by slice.

- Slice 1, the genotype-operator path: PLINK .bed ingest -> scaling ->
  randomized SVD -> phenotype simulation -> GWAS -> C+T scores, with the
  fused 2-bit decode + GEMM as hand-written CUDA kernels
  (`ops/geno_kernels.py`, `csrc/geno_split.cu`: K1 and K2 on exact bf16
  bit planes).
- Slice 2, LD and LDpred2: windowed LD (`snp_cor`, exact integer pair
  sums) -> LDSC h2 (`snp_ldsc2`) -> LD blocks (`auto_blocks`,
  `snp_ldsplit`, `build_block_bands`) -> LDpred2-auto and -grid on the
  blocked sampler -> chain QC -> `snp_PRS`, with the Gibbs sweep as a
  hand-written CUDA kernel (`ops/gibbs_kernels.py`,
  `csrc/gibbs_sweep.cu`).
- Slice 3, population structure: `snp_autoSVD` (clumping, the robust
  long-range-LD outlier loop) -> `snp_pcadapt` -> `bed_projectSelfPCA`,
  and the "int8" scheme of the genotype operator (`config.pallas_mxu`),
  the kernel K6 on exact int8 bit planes (`csrc/geno_i8.cu`).
- Slice 4, polygenic scores after the GWAS: the "split2" scheme of the
  operator, the kernel K7 on exact bf16 bit planes with the operand split
  into bf16 hi + lo (`csrc/geno_split.cu`), under randomSVD and the GWAS;
  Stacked C+T (`snp_grid_clumping` on a native O(m + E) greedy,
  `snp_grid_PRS`, `snp_grid_stacking` on the native elastic-net CD of
  `big_spReg`); and blocked lassosum2 (`snp_lassosum2(blocks=...)`) on
  the sweep kernel's lassosum mode.
- Slice 5, the unblocked samplers: the "int8m" scheme (`mxu="int8m"`,
  K8 on int8 planes materialized once, in `csrc/geno_i8.cu` beside K6)
  under `snp_randomSVD(op=)` -> GWAS -> `snp_cor` -> `snp_ldsc2` -> the
  unblocked LDpred2-auto, -grid, sampling betas and lassosum2 on the
  sweep kernel, one band over every variant.
- Slice 6a-6b, data in and the remaining statistics: allele matching
  (`snp_match`, `same_ref`, `snp_asGeneticPos(2)`), `bed_projectPCA`
  (matching, autoSVD of the reference on K1 / K2, OADP projection), the
  `.gpk` store (`GenoPack.save`, `snp_save`, `snp_attach`,
  `snp_readBed(backingfile=)`), reference `.rds` + `.bk` pairs
  (`snp_attach_rds`), the GRM (`bed_tcrossprodSelf`, `bed_GRM`: device
  decode + a float32 GEMM update), `snp_MAX3`, `snp_fst`,
  `snp_ancestry_summary`, `snp_scaleAlpha`, the plots (`snp_qq`,
  `snp_manhattan`), `trace` (torch.profiler) and the small helpers of
  `utils/misc`.
- Slice 6c, imputed dosages and the host tools: byte-coded dosages
  (`DosagePack`, the FBM.code256 analog, with the tables `CODE_012`,
  `CODE_DOSAGE`, `CODE_IMPUTE_PRED`; its `.dpk` store; `snp_attach_rds`
  of a dosage table) through statistics, products, randomSVD, `snp_cor`,
  LD scores, clumping and the SCT grid on the byte path (a code256 gather
  and a float32 GEMM in torch, as the JAX package's byte path is XLA);
  BGEN v1.2 in (`snp_readBGI` on sqlite3, `snp_readBGEN` on a native
  zlib decode, `snp_prodBGEN`); the external-tool wrappers
  (`snp_plinkQC`, `snp_plinkRmSamples`, `snp_plinkIBDQC`,
  `snp_plinkKINGQC`, `snp_beagleImpute`, `snp_modifyBuild`; the
  `download_*` helpers raise: no network); and `warmup` / `warmup_svd` /
  `warmup_gibbs` (build every source, launch each kernel once).
- Still to come (ROADMAP queue 1): `snp_fastImpute` and
  `snp_fastImputeSimple` (slice 6c, item 13), then slice 7 (several
  cards).

Entry points run on the CUDA device unless the caller asks for the CPU
(`config.set_device("cpu")` or `device="cpu"`). The package imports
torch, numpy and scipy, and nothing of the JAX package.
"""

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core.genotypes import (
    GenoPack,
    snp_fake,
    snp_subset,
    snp_attach,
    snp_attach_rds,
    snp_save,
)
from bigsnpr_tpu_torch.io.bed import (
    read_bed,
    bed,
    snp_readBed,
    snp_readBed2,
    snp_writeBed,
    snp_attachExtdata,
)
from bigsnpr_tpu_torch.ops.stats import (
    snp_colstats,
    snp_counts,
    bed_counts,
    snp_MAF,
    bed_MAF,
    snp_scaleBinom,
    bed_scaleBinom,
    snp_scaleAlpha,
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
from bigsnpr_tpu_torch.ops.clumping import snp_clumping, bed_clumping, snp_indLRLDR
from bigsnpr_tpu_torch.pca.autosvd import snp_autoSVD, bed_autoSVD
from bigsnpr_tpu_torch.pca.project import (
    bed_projectPCA,
    bed_projectSelfPCA,
    snp_projectSelfPCA,
    pca_OADP_proj,
)
from bigsnpr_tpu_torch.assoc.pcadapt import snp_pcadapt, bed_pcadapt
from bigsnpr_tpu_torch.assoc.mhtest import (
    MHTest,
    snp_gc,
    mhtest_from_gwas,
    snp_qq,
    snp_manhattan,
)
from bigsnpr_tpu_torch.assoc.max3 import snp_MAX3
from bigsnpr_tpu_torch.assoc.fst import snp_fst
from bigsnpr_tpu_torch.utils.profiling import StageTimer, trace
from bigsnpr_tpu_torch.utils.match import (
    snp_match,
    same_ref,
    snp_asGeneticPos,
    snp_asGeneticPos2,
)
from bigsnpr_tpu_torch.ops.grm import bed_tcrossprodSelf, bed_GRM
from bigsnpr_tpu_torch.pca.ancestry import snp_ancestry_summary
from bigsnpr_tpu_torch.utils.misc import (
    sub_bed,
    as_SFBM,
    snp_getSampleInfos,
    snp_split,
    snp_pruning,
    download_1000G,
    download_genetic_map,
)
from bigsnpr_tpu_torch.assoc.simu import snp_simuPheno
from bigsnpr_tpu_torch.assoc.gwas import big_univLinReg, big_univLogReg, gwas_pvalues
from bigsnpr_tpu_torch.pgs.prs import snp_PRS, snp_thr_correct
from bigsnpr_tpu_torch.ops.corr import SparseLD, snp_cor, bed_cor
from bigsnpr_tpu_torch.ops.ldscores import (
    snp_ld_scores,
    bed_ld_scores,
    ld_scores_sfbm,
)
from bigsnpr_tpu_torch.ops.splitld import snp_ldsplit, block_num
from bigsnpr_tpu_torch.pgs.ldsc import snp_ldsc, snp_ldsc2, coef_to_liab
from bigsnpr_tpu_torch.pgs.gibbs_blocked import (
    BlockBands,
    auto_blocks,
    build_block_bands,
)
from bigsnpr_tpu_torch.pgs.ldpred2 import (
    snp_ldpred2_inf,
    snp_ldpred2_grid,
    snp_ldpred2_auto,
    ldpred2_auto_chain_qc,
)
from bigsnpr_tpu_torch.pgs.lassosum2 import snp_lassosum2, seq_log
from bigsnpr_tpu_torch.linalg.penalized import (
    SpRegModel,
    big_spReg,
    big_spLinReg,
    big_spLogReg,
)
from bigsnpr_tpu_torch.pgs.sct import (
    GridPRS,
    snp_grid_clumping,
    snp_grid_PRS,
    snp_grid_stacking,
)

from bigsnpr_tpu_torch.core.dosage import DosagePack
from bigsnpr_tpu_torch.core.codes import CODE_012, CODE_DOSAGE, CODE_IMPUTE_PRED
from bigsnpr_tpu_torch.io.bgen import snp_readBGEN, snp_readBGI, snp_prodBGEN
from bigsnpr_tpu_torch.utils.external import (
    snp_plinkQC,
    snp_plinkRmSamples,
    snp_plinkIBDQC,
    snp_plinkKINGQC,
    snp_beagleImpute,
    snp_modifyBuild,
    download_plink,
    download_plink2,
    download_beagle,
)
from bigsnpr_tpu_torch.warmup import warmup, warmup_svd, warmup_gibbs

__version__ = "0.1.0"
