"""Wrappers around external binaries (PLINK 1.9 / 2.0, Beagle, liftOver)
(port of `bigsnpr_tpu/utils/external.py`).

Reference: R/external-software.R + R/modify-positions.R:33-92. These are
host-side subprocess drivers; the command lines are the JAX package's, which
mirror the reference's. Binaries are user-provided paths: the download
helpers need network egress and raise with instructions instead. Tables
are dicts of numpy columns (port DEVIATIONS #1): a table a wrapper reads
back (`.genome`, `.kin0`) is parsed without pandas by the reader of
`snp_getSampleInfos` (whitespace-separated, a header line).
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from bigsnpr_tpu_torch.utils.misc import _read_header_table as read_table


def _run(cmd: list, verbose: bool = False):
    res = subprocess.run([str(c) for c in cmd],
                         capture_output=not verbose, text=True)
    if res.returncode != 0:
        tail = (res.stderr or res.stdout or "")[-2000:] if not verbose else ""
        raise RuntimeError(f"command failed ({res.returncode}): "
                           f"{' '.join(map(str, cmd))}\n{tail}")
    return res


def _sub_bed(bedfile) -> str:
    s = str(bedfile)
    return s[:-4] if s.endswith(".bed") else s


def _table_rows(table):
    """The rows of a dict of columns (or anything with keys() and column
    access) as tuples."""
    cols = [np.asarray(table[k]) for k in table.keys()]
    return list(zip(*cols))


def download_plink(dir=None, overwrite=False, verbose=True):
    raise RuntimeError(
        "No network egress in this environment; provide a PLINK binary path "
        "to the snp_plink* functions instead (reference downloads from "
        "www.cog-genomics.org).")


download_plink2 = download_plink


def download_beagle(dir=None):
    raise RuntimeError(
        "No network egress in this environment; provide beagle.jar's path "
        "to snp_beagleImpute instead.")


def snp_plinkQC(plink_path, prefix_in, file_type="--bfile", prefix_out=None,
                maf=0.01, geno=0.1, mind=0.1, hwe=1e-50, autosome_only=False,
                extra_options="", verbose=False) -> str:
    """PLINK QC (reference snp_plinkQC, R/external-software.R:247-290)."""
    if prefix_out is None:
        prefix_out = f"{prefix_in}_QC"
    args = [plink_path, file_type, prefix_in,
            "--maf", maf, "--mind", mind, "--geno", geno, "--hwe", hwe]
    if autosome_only:
        args.append("--autosome")
    args += ["--make-bed", "--out", prefix_out]
    if extra_options:
        args += str(extra_options).split()
    _run(args, verbose)
    return f"{prefix_out}.bed"


def snp_plinkRmSamples(plink_path, bedfile_in, bedfile_out, df_or_files,
                       verbose=False) -> str:
    """Remove samples (reference snp_plinkRmSamples,
    R/external-software.R:308-343). df_or_files: a table of the samples
    to remove (a dict of columns, e.g. family and sample IDs; written
    tab-separated without a header) or lines of a PLINK remove file."""
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        if hasattr(df_or_files, "keys"):
            f.write("".join("\t".join(map(str, row)) + "\n"
                            for row in _table_rows(df_or_files)))
        else:
            f.write("\n".join(map(str, df_or_files)))
        tmp = f.name
    _run([plink_path, "--bfile", _sub_bed(bedfile_in), "--make-bed",
          "--out", _sub_bed(bedfile_out), "--remove", tmp], verbose)
    os.unlink(tmp)
    return str(bedfile_out)


def snp_plinkIBDQC(plink_path, bedfile_in, bedfile_out=None, pi_hat=0.08,
                   ncores=1, pruning_args=(100, 0.2), do_blind_QC=True,
                   verbose=False):
    """Relatedness QC via IBD (reference snp_plinkIBDQC,
    R/external-software.R:401-472). Returns the .genome table (a dict of
    columns) without do_blind_QC, else the new .bed's path."""
    prefix_in = _sub_bed(bedfile_in)
    if bedfile_out is None:
        bedfile_out = f"{prefix_in}_norel.bed"
    tmp = tempfile.mktemp()
    opt_extract = []
    if pruning_args is not None:
        _run([plink_path, "--bfile", prefix_in, "--indep-pairwise",
              pruning_args[0], 1, pruning_args[1], "--out", tmp], verbose)
        opt_extract = ["--extract", f"{tmp}.prune.in"]
    _run([plink_path, "--bfile", prefix_in, *opt_extract, "--genome",
          "--min", pi_hat, "--out", tmp, "--threads", ncores], verbose)
    genome = read_table(f"{tmp}.genome")
    if not do_blind_QC:
        return genome
    # the distinct (FID2, IID2) pairs, in order of first appearance
    pairs = dict.fromkeys(zip(genome["FID2"].tolist(),
                              genome["IID2"].tolist()))
    rm = {"FID": np.array([p[0] for p in pairs]),
          "IID": np.array([p[1] for p in pairs])}
    return snp_plinkRmSamples(plink_path, bedfile_in, bedfile_out, rm,
                              verbose=verbose)


def snp_plinkKINGQC(plink2_path, bedfile_in, bedfile_out=None,
                    thr_king=2**-3.5, make_bed=True, ncores=1, verbose=False):
    """KING-robust kinship QC (reference snp_plinkKINGQC,
    R/external-software.R:520+). Returns the new .bed's path, or with
    make_bed=False the .kin0 table (a dict of columns)."""
    prefix_in = _sub_bed(bedfile_in)
    if make_bed:
        if bedfile_out is None:
            bedfile_out = f"{prefix_in}_norel.bed"
        _run([plink2_path, "--bfile", prefix_in, "--make-bed",
              "--king-cutoff", thr_king, "--out", _sub_bed(bedfile_out),
              "--threads", ncores], verbose)
        return str(bedfile_out)
    prefix_out = tempfile.mktemp()
    _run([plink2_path, "--bfile", prefix_in, "--make-king-table",
          "--king-table-filter", thr_king, "--out", prefix_out,
          "--threads", ncores], verbose)
    return read_table(f"{prefix_out}.kin0")


def snp_beagleImpute(beagle_path, plink_path, bedfile_in, bedfile_out=None,
                     memory_max=3, ncores=1, extra_options="",
                     plink_options="", verbose=False) -> str:
    """Beagle phasing / imputation driver (reference snp_beagleImpute,
    R/external-software.R:615+): bed -> vcf.gz -> beagle -> bed."""
    prefix_in = _sub_bed(bedfile_in)
    if bedfile_out is None:
        bedfile_out = f"{prefix_in}_impute.bed"
    tmp1, tmp2 = tempfile.mktemp(), tempfile.mktemp()
    _run([plink_path, "--bfile", prefix_in, "--recode", "vcf", "bgz",
          "--out", tmp1, "--threads", ncores], verbose)
    cmd = ["java", f"-Xmx{memory_max}g", "-jar", beagle_path,
           f"gt={tmp1}.vcf.gz", f"out={tmp2}", f"nthreads={ncores}"]
    if extra_options:
        cmd += str(extra_options).split()
    _run(cmd, verbose)
    _run([plink_path, "--vcf", f"{tmp2}.vcf.gz", "--make-bed",
          "--out", _sub_bed(bedfile_out), "--threads", ncores,
          *str(plink_options).split()], verbose)
    return str(bedfile_out)


def snp_modifyBuild(info_snp, liftover_path, from_build="hg18",
                    to_build="hg19", check_reverse=True,
                    verbose=False) -> dict:
    """Genome-build liftover (reference snp_modifyBuild,
    R/modify-positions.R:33-92): write UCSC BED, run liftOver, join back;
    positions that fail become NaN. info_snp: a dict of columns with "chr"
    and "pos"; returns a copy with "pos" lifted (float64)."""
    assert {"chr", "pos"} <= set(info_snp.keys())
    chain = f"{from_build}To{to_build.capitalize()}.over.chain.gz"
    chain_path = Path(chain)
    if not chain_path.exists():
        raise FileNotFoundError(
            f"liftOver chain file {chain} not found in cwd (no network "
            "egress to download it).")

    def lift(table, chain_file):
        bed = tempfile.mktemp(suffix=".bed")
        out = tempfile.mktemp(suffix=".bed")
        unmapped = tempfile.mktemp(suffix=".txt")
        with open(bed, "w") as f:
            for i, (c, p) in enumerate(zip(table["chr"], table["pos"])):
                f.write(f"chr{c}\t{int(p) - 1}\t{int(p)}\t{i}\n")
        _run([liftover_path, bed, chain_file, out, unmapped], verbose)
        new_pos = np.full(len(table["pos"]), np.nan)
        with open(out) as f:
            for line in f:
                c, s, e, idx = line.split()
                new_pos[int(idx)] = int(e)
        return new_pos

    out = {k: np.array(info_snp[k], copy=True) for k in info_snp.keys()}
    out["pos"] = lift(info_snp, str(chain_path))
    return out
