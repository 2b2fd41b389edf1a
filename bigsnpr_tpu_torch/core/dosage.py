"""Byte-coded dosage container (the FBM.code256 analog; port of
`bigsnpr_tpu/core/dosage.py`).

For imputed data (BGEN) a 2-bit packing cannot hold 201 dosage levels:
`DosagePack` keeps one byte per genotype plus a 256-entry decode table
(reference R/bigSNP-class.R:13 CODE_DOSAGE), variant-major like
`GenoPack`. `fam` and `map` are dicts of numpy columns (port DEVIATIONS
#1). The device copy of the codes is in true variant order (the JAX
package pads it with NA rows to its `lax.map` block), uploaded once per
device and cached, like `GenoPack.device_packed`.

The `.dpk` store is the JAX package's: `codes.bin` (the (m, n) bytes),
`code256.npy` and `meta.json` byte for byte, and `fam` / `map` as
parquet written and read with pyarrow, imported only when a pack carries
them (port DEVIATIONS #9).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core import unpack
from bigsnpr_tpu_torch.core.codes import CODE_DOSAGE
from bigsnpr_tpu_torch.core.genotypes import (
    GenoPack,
    _read_parquet,
    _write_parquet,
    take_rows,
    upload_rows,
    write_rows,
)


def hardcall_lut(code256) -> np.ndarray:
    """Byte code -> 2-bit code of its dosage rounded to a hard call (half
    to even, as np.rint), NA where the table is NaN or out of {0, 1, 2}."""
    table = np.asarray(code256, dtype=np.float64)
    return unpack.np_dosage_to_codes(np.rint(table)[None, :])[0]


@dataclass
class DosagePack:
    """codes: (m, n) uint8 (numpy or numpy.memmap), decoded through
    code256."""

    codes: np.ndarray
    n: int
    code256: np.ndarray = None
    fam: Optional[dict] = None
    map: Optional[dict] = None
    _device_cache: dict = field(default_factory=dict, repr=False,
                                compare=False)

    def __post_init__(self):
        if self.code256 is None:
            self.code256 = CODE_DOSAGE

    @property
    def m(self) -> int:
        return self.codes.shape[0]

    @property
    def shape(self):
        """(n_samples, m_variants), the reference's G orientation."""
        return (self.n, self.m)

    def device_codes(self, device=None) -> torch.Tensor:
        """The codes as a (m, n) uint8 tensor on `device` (cached per
        device), uploaded in row chunks into one preallocated tensor."""
        dev = config.resolve_device(device)
        key = str(dev)
        if key not in self._device_cache:
            self._device_cache[key] = upload_rows(self.codes, dev)
        return self._device_cache[key]

    def to_dosage(self) -> np.ndarray:
        """(n, m) float64 dosages with NaN for missing (host-side)."""
        return self.code256[np.asarray(self.codes)].T

    def subset(self, ind_row=None, ind_col=None,
               device=None) -> "DosagePack":
        """Materialized subset. With `device` given, or a device copy
        cached, the bytes are gathered on that device and the result keeps
        its device copy; otherwise on the host."""
        new_fam = (take_rows(self.fam, ind_row) if ind_row is not None
                   else self.fam)
        new_map = (take_rows(self.map, ind_col) if ind_col is not None
                   else self.map)
        if device is None and not self._device_cache:
            codes = self.codes
            if ind_col is not None:
                codes = codes[np.asarray(ind_col)]
            if ind_row is not None:
                codes = codes[:, np.asarray(ind_row)]
            return DosagePack(codes=np.ascontiguousarray(codes),
                              n=codes.shape[1], code256=self.code256,
                              fam=new_fam, map=new_map)
        dev = config.resolve_device(device)
        src = self.device_codes(dev)
        if ind_col is not None:
            src = src[torch.as_tensor(np.asarray(ind_col), dtype=torch.long,
                                      device=dev)]
        if ind_row is not None:
            src = src[:, torch.as_tensor(np.asarray(ind_row),
                                         dtype=torch.long, device=dev)]
        src = src.contiguous()
        sub = DosagePack(codes=src.cpu().numpy(), n=src.shape[1],
                         code256=self.code256, fam=new_fam, map=new_map)
        sub._device_cache[str(dev)] = src
        return sub

    def round_to_hardcalls(self) -> GenoPack:
        """Round dosages to hard calls (NaN kept missing) -> GenoPack,
        through a 256-entry lookup table, a chunk of variants at a time;
        on the device of a cached device copy (the GenoPack keeps it)."""
        lut = hardcall_lut(self.code256)
        if self._device_cache:
            key, src = next(iter(self._device_cache.items()))
            lut_t = torch.as_tensor(lut, device=src.device)
            out = torch.empty((self.m, (self.n + 3) // 4), dtype=torch.uint8,
                              device=src.device)
            step = max(1, (32 << 20) // max(self.n, 1))   # int64 indices
            for r0 in range(0, self.m, step):
                out[r0:r0 + step] = unpack.pack_codes(
                    lut_t[src[r0:r0 + step].long()])
            pack = GenoPack(packed=out.cpu().numpy(), n=self.n,
                            fam=self.fam, map=self.map)
            pack._device_cache[key] = out
            return pack
        packed = np.empty((self.m, (self.n + 3) // 4), dtype=np.uint8)
        step = max(1, (1 << 24) // max(self.n, 1))
        for r0 in range(0, self.m, step):
            packed[r0:r0 + step] = unpack.np_pack_codes(
                lut[self.codes[r0:r0 + step]])
        return GenoPack(packed=packed, n=self.n, fam=self.fam, map=self.map)

    def save(self, path) -> str:
        """Persist as <name>.dpk/ (codes, code256 and metadata); a pack
        whose codes are already the memmap of that store (a streamed
        ingest) is flushed in place. Returns the store's path."""
        path = Path(path)
        if path.suffix != ".dpk":
            path = path.with_suffix(".dpk")
        path.mkdir(parents=True, exist_ok=True)
        target = path / "codes.bin"
        if (isinstance(self.codes, np.memmap)
                and Path(self.codes.filename).resolve() == target.resolve()):
            self.codes.flush()
        else:
            write_rows(self.codes, target)
        np.save(path / "code256.npy", self.code256)
        (path / "meta.json").write_text(json.dumps(
            {"n": int(self.n), "m": int(self.m), "version": 1}))
        if self.fam is not None:
            _write_parquet(path / "fam.parquet", self.fam)
        if self.map is not None:
            _write_parquet(path / "map.parquet", self.map)
        return str(path)

    @staticmethod
    def load(path, mmap: bool = True) -> "DosagePack":
        """Attach a `.dpk` store, the port's or the JAX package's."""
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        n, m = meta["n"], meta["m"]
        if mmap:
            codes = np.memmap(path / "codes.bin", dtype=np.uint8, mode="r",
                              shape=(m, n))
        else:
            codes = np.fromfile(path / "codes.bin",
                                dtype=np.uint8).reshape(m, n)
        fam = (_read_parquet(path / "fam.parquet")
               if (path / "fam.parquet").exists() else None)
        map_ = (_read_parquet(path / "map.parquet")
                if (path / "map.parquet").exists() else None)
        return DosagePack(codes=codes, n=n,
                          code256=np.load(path / "code256.npy"),
                          fam=fam, map=map_)
