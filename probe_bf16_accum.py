"""Accuracy and time of the bf16 products of `ops/precision.py` on the card,
at the shapes of the imputation's ridge block (512 x 33 x 20,000 x 33,
batched) and of a GRM block (10,000 x 6,704 x 10,000): one cuBLAS call over
the whole depth (`chunk` 0), the depth in pieces of `chunk` summed in
float32 (`precision.DEPTH_CHUNK`, the shipped value, among them), and the
IEEE float32 product of the same bf16-valued operands (TF32 off). Errors
are max |. - float64| / max |float64| of the product of the bf16 operands
that the name multiplies.

    python3 probe_bf16_accum.py            (on a card, ~15 s of command)
"""

import subprocess
import sys

import torch

sys.path.insert(0, ".")
from bigsnpr_tpu_torch.ops import precision  # noqa: E402

dev = torch.device("cuda")
f32 = torch.float32


def timed(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b) / reps


def product(A, B, chunk):
    """The bf16 product in float32, the depth in pieces of `chunk` (0: one
    call)."""
    if chunk == 0:
        op = torch.ops.aten.bmm if A.dim() == 3 else torch.ops.aten.mm
        return op.dtype(A, B, f32)
    old, precision.DEPTH_CHUNK = precision.DEPTH_CHUNK, chunk
    try:
        return precision._accumulate_bf16(precision._new(A, B), A, B)
    finally:
        precision.DEPTH_CHUNK = old


def report(what, A, B):
    ref = A.double() @ B.double()
    top = ref.abs().max().item()
    rows = [(f"chunk {c}" + (" (shipped)" if c == precision.DEPTH_CHUNK
                             else ""), lambda c=c: product(A, B, c))
            for c in (0, 1024, 2048, 4096)]
    rows.append(("float32 product", lambda: A.float() @ B.float()))
    for label, fn in rows:
        out, ms = timed(fn)
        err = (out.double() - ref).abs().max().item() / top
        print(f"{what:24s} {label:18s} rel err {err:.2e}  {ms:8.3f} ms",
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("probe_bf16_accum: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"torch {torch.__version__}; nvidia-smi: {smi}")
    g = torch.Generator(device=dev).manual_seed(1)
    # ridge block: mean-imputed dosages 0..2 and an intercept row
    F = torch.randint(0, 3, (512, 33, 20000), generator=g,
                      device=dev).float()
    F += 0.37 * (torch.rand(F.shape, generator=g, device=dev) < 0.05)
    F[:, 0] = 1
    for name in ("default", "high"):
        report(f"ridge G, {name}", *precision.operands(
            F, F.transpose(1, 2), name))
    del F
    X = torch.randn((6704, 10000), generator=g, device=dev)
    for name in ("default", "high"):
        report(f"GRM block, {name}", *precision.operands(X.T, X, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
