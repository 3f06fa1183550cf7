"""Time text variants of the port's CUDA sources on one card, in turns.

    python3 scripts/torch_kernel_variants.py 'base=' 'name=old>>new||old>>new' ...

Each variant copies ``sonar_tpu_torch/csrc/``, applies its replacements
(each ``old`` must occur in exactly one source file; ``\\n`` in a spec is a
newline, and a spec cannot hold ``||`` or ``>>`` in its text), builds a
library of its own under ``build/variants/<name>/`` and is timed, in turns
(the variants in order, then in reverse), with CUDA events behind a GPU
spin, beside its largest error against the plain version:

- rel-pos v1 (``relpos_flash_attention``) at [8, 16, 499, 64] in bf16 and
  fp32, the key bias with a ragged row and a row of length 0;
- ``beam_reorder_attend`` in bf16 at B 32, K 5, H 16, S 51, Dh 64, idx 25
  with a random sel and with one row named by every beam of a sentence,
  and at S 259, idx 200 with a random sel, warm and with a cold L2 (a
  256 MB write before each call).

An empty spec (``base=``) is the source as it is. Ablations (a variant that
skips work) give wrong results by design: only their times mean anything.
Prints the card's name and power limit first.
"""

from pathlib import Path
import shutil
import subprocess
import sys

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from sonar_tpu_torch.ops import _build  # noqa: E402
from sonar_tpu_torch.ops.cuda import beam_attend, relpos_flash  # noqa: E402


def build(name: str, spec: str):
    """The kernel library of one variant, or None if it does not build."""
    root = REPO / "build" / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "sonar_tpu_torch" / "csrc", root / "csrc")
    sources = sorted((root / "csrc").glob("*.cu*"))
    for rep in filter(None, spec.split("||")):
        old, new = (t.replace("\\n", "\n") for t in rep.split(">>"))
        hits = [src for src in sources if old in src.read_text()]
        assert len(hits) == 1, f"{name}: {old!r} is in {len(hits)} source files"
        hits[0].write_text(hits[0].read_text().replace(old, new))
    _build.CSRC, _build.BUILD_DIR, _build._lib = root / "csrc", root / "out", None
    try:
        return _build.library()
    except RuntimeError as e:
        print(name, "does not build:", str(e)[-3000:], flush=True)
        return None


def timed(fn, iters=20) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # queue the calls behind a spin, not the host
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def timed_cold(fn, iters=20) -> float:
    """The median ms of one call after a 256 MB write (five times the L2)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in events)[iters // 2]


def cases():
    """(label, kernel call, plain call, pick the compared output, time cold too)."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    out = []
    b, h, s, dh = 8, 16, 499, 64
    lens = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lens[0], lens[-1] = s, 0
    kb = torch.where(torch.arange(s, device="cuda")[None, :] < lens[:, None], 0.0,
                     torch.finfo(torch.float32).min).float()
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, bd = rand(b, h, s, dh, dtype=dt), rand(b, h, s, dh, dtype=dt), \
            rand(b, h, s, dh, dtype=dt), rand(b, h, s, s, dtype=dt, scale=0.3)
        u = rand(h, dh, dtype=dt, scale=0.1)
        args = (q, k, v, bd, u, kb)
        out.append((f"relpos_flash_attention [{b},{h},{s},{dh}] {str(dt)[6:]}",
                    lambda args=args: relpos_flash.relpos_flash_attention(*args),
                    lambda args=args: relpos_flash.relpos_flash_attention_plain(*args),
                    lambda o: o, False))
    b, beam, h, dh = 32, 5, 16, 64
    for s, idx, kind in ((51, 25, "random"), (51, 25, "one-row"), (259, 200, "random")):
        pos = torch.arange(s, device="cuda")
        sel = torch.randint(0, beam, (b, beam), generator=g, device="cuda", dtype=torch.int32)
        if kind == "one-row":
            sel = sel[:, :1].expand(b, beam).contiguous()
        args = (rand(b, beam, h, dh), rand(b, beam, h, dh), rand(b, beam, h, dh),
                rand(b, h, beam, s, dh), rand(b, h, beam, s, dh), sel,
                torch.where(pos <= idx, 0.0, -1e30).float(), (pos == idx).float())
        out.append((f"beam_reorder_attend B {b} S {s} idx {idx} {kind} sel bf16",
                    lambda args=args: beam_attend.beam_reorder_attend(*args),
                    lambda args=args: beam_attend.beam_reorder_attend_plain(*args),
                    lambda o: o[0], True))
    return out


def main(argv) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    variants = dict(v.split("=", 1) for v in argv)
    libs = {name: build(name, spec) for name, spec in variants.items()}
    libs = [(name, lib) for name, lib in libs.items() if lib is not None]
    for label, fn, plain, pick, cold in cases():
        want = pick(plain()).double()
        for name, lib in libs + libs[::-1]:
            _build._lib = lib
            err = (pick(fn()).double() - want).abs().max().item()
            line = f"{label} {name}: {timed(fn):.4f} ms"
            if cold:
                line += f", cold L2 {timed_cold(fn):.4f} ms"
            print(f"{line}, max abs error {err:.2e}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
