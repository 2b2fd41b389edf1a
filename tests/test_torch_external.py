"""The port's external-tool wrappers against the JAX package's, on fake
binaries that record their command lines (no PLINK, Beagle, Java or
liftOver here; tests/test_external_wrappers.py's approach): the same
command lines, the same files handed to the tools, the same tables read
back (the port's as dicts of columns), and the downloads raise."""

import os
import re
import stat
import tempfile

import numpy as np
import pandas as pd
import pytest

from bigsnpr_tpu.utils import external as jext
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.utils import external as pext

FAKE = """#!/bin/bash
echo "$(basename "$0") $@" >> {log}
out=""; prev=""; remove=""
for a in "$@"; do
  if [ "$prev" == "--out" ]; then out="$a"; fi
  if [ "$prev" == "--remove" ]; then remove="$a"; fi
  case "$a" in out=*) out="${{a#out=}}";; esac
  prev="$a"
done
if [ -n "$remove" ]; then echo "remove-file:" >> {log}; cat "$remove" >> {log}; echo >> {log}; fi
if [ -n "$out" ]; then
  touch "$out.bed" "$out.bim" "$out.fam" "$out.prune.in" "$out.vcf.gz"
  printf "FID1 IID1 FID2 IID2 PI_HAT\\nF1 S1 F2 S2 0.31\\nF1 S1 F3 S3 0.12\\nF4 S4 F2 S2 0.5\\n" > "$out.genome"
  printf "#FID1\\tIID1\\tFID2\\tIID2\\tKINSHIP\\nF1\\tS1\\tF2\\tS2\\t0.2\\n" > "$out.kin0"
fi
exit 0
"""


@pytest.fixture()
def fakes(tmp_path, monkeypatch):
    """Fake `plink` and `java` (on PATH) that record their argv (and the
    contents of a --remove file) in one log."""
    log = tmp_path / "calls.log"
    bins = tmp_path / "bin"
    bins.mkdir()
    for name in ("plink", "java"):
        f = bins / name
        f.write_text(FAKE.format(log=log))
        f.chmod(f.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bins}:{os.environ['PATH']}")
    return bins / "plink", log


def calls(log):
    """The recorded calls with temporary file names made generic; the log
    is emptied."""
    tmp = re.escape(tempfile.gettempdir())
    text = re.sub(tmp + r"/[^\s]+?(?=(\.[a-z0-9.]+)?(\s|$))", "<tmp>",
                  log.read_text())
    log.write_text("")
    return text


def both(log, fn_name, *args, **kw):
    """Run the JAX package's wrapper and the port's on the same arguments;
    their recorded calls must be equal. Returns their results and the
    port's calls."""
    out_j = getattr(jext, fn_name)(*args, **kw)
    calls_j = calls(log)
    out_p = getattr(pext, fn_name)(*args, **kw)
    calls_p = calls(log)
    assert calls_p == calls_j and calls_j
    return out_j, out_p, calls_p


def test_plink_qc(fakes, tmp_path):
    plink, log = fakes
    for kw in (dict(maf=0.05, geno=0.2, mind=0.3, hwe=1e-10,
                    autosome_only=True),
               dict(prefix_out=str(tmp_path / "o"), extra_options="--chr 1-3",
                    file_type="--pfile")):
        a, b, _ = both(log, "snp_plinkQC", plink, str(tmp_path / "data"), **kw)
        assert a == b


def test_plink_rm_samples(fakes, tmp_path):
    """A table of samples (the JAX package: a DataFrame; the port: a dict
    of columns, or a DataFrame) and a list of lines give the same remove
    file."""
    plink, log = fakes
    df = pd.DataFrame({"FID": ["F1", "F2"], "IID": ["S1", "S2"]})
    out_j = jext.snp_plinkRmSamples(plink, tmp_path / "in.bed",
                                    tmp_path / "out.bed", df)
    ref = calls(log)
    assert "remove-file:\nF1\tS1\nF2\tS2" in ref
    for table in ({"FID": np.array(["F1", "F2"]),
                   "IID": np.array(["S1", "S2"])}, df):
        out_p = pext.snp_plinkRmSamples(plink, tmp_path / "in.bed",
                                        tmp_path / "out.bed", table)
        assert calls(log) == ref and out_p == out_j
    a, b, _ = both(log, "snp_plinkRmSamples", plink, tmp_path / "in.bed",
                   tmp_path / "out.bed", ["F7 S7", "F8 S8"])
    assert a == b


def test_plink_ibd_qc(fakes, tmp_path):
    plink, log = fakes
    a, b, _ = both(log, "snp_plinkIBDQC", plink, tmp_path / "in.bed")
    assert a == b and b.endswith("in_norel.bed")
    a, b, _ = both(log, "snp_plinkIBDQC", plink, tmp_path / "in.bed",
                   pruning_args=None, do_blind_QC=False, pi_hat=0.1, ncores=3)
    assert list(a.columns) == list(b)
    for k in b:
        assert a[k].tolist() == b[k].tolist()


def test_plink_king_qc(fakes, tmp_path):
    plink, log = fakes
    a, b, _ = both(log, "snp_plinkKINGQC", plink, tmp_path / "in.bed",
                   ncores=2)
    assert a == b and b.endswith("_norel.bed")
    a, b, _ = both(log, "snp_plinkKINGQC", plink, tmp_path / "in.bed",
                   make_bed=False, thr_king=0.1)
    assert list(a.columns) == list(b)
    assert a["KINSHIP"].tolist() == b["KINSHIP"].tolist()


def test_empty_table_raises_as_pandas(tmp_path):
    empty = tmp_path / "e.kin0"
    empty.write_text("")
    with pytest.raises(pd.errors.EmptyDataError):
        pd.read_csv(empty, sep=r"\s+")
    with pytest.raises(ValueError):
        pext.read_table(empty)


def test_beagle_impute(fakes, tmp_path):
    plink, log = fakes
    a, b, seen = both(log, "snp_beagleImpute", tmp_path / "beagle.jar",
                      plink, tmp_path / "in.bed", memory_max=5, ncores=2,
                      extra_options="window=10", plink_options="--chr 2")
    assert a == b and b.endswith("in_impute.bed")
    assert "java -Xmx5g -jar" in seen and "window=10" in seen


def test_modify_build(tmp_path, monkeypatch):
    lift = tmp_path / "liftOver"
    lift.write_text("""#!/bin/bash
bed="$1"; out="$3"; unmapped="$4"
awk '$2 != 4999 {printf "%s\\t%d\\t%d\\t%s\\n", $1, $2+1000, $3+1000, $4}' \
  "$bed" > "$out"
touch "$unmapped"
""")
    lift.chmod(lift.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "hg18ToHg19.over.chain.gz").write_bytes(b"fake")
    monkeypatch.chdir(tmp_path)
    info = {"chr": np.array([1, 1, 2]), "pos": np.array([1000, 5000, 700]),
            "rsid": np.array(["a", "b", "c"])}
    a = jext.snp_modifyBuild(pd.DataFrame(info), str(lift))
    b = pt.snp_modifyBuild(info, str(lift))
    assert list(a.columns) == list(b)
    np.testing.assert_array_equal(b["pos"], a["pos"].to_numpy())
    assert np.isnan(b["pos"][1]) and b["pos"][0] == 2000
    assert b["rsid"].tolist() == ["a", "b", "c"]
    assert info["pos"].tolist() == [1000, 5000, 700]       # not modified
    with pytest.raises(FileNotFoundError):
        pt.snp_modifyBuild(info, str(lift), to_build="hg38")


@pytest.mark.parametrize("name", ["download_plink", "download_plink2",
                                  "download_beagle"])
def test_downloads_raise(name):
    for mod in (jext, pext):
        with pytest.raises(RuntimeError, match="egress"):
            getattr(mod, name)()
