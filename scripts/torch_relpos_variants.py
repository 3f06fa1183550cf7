"""Time variants of the port's rel-pos v2 kernel on one CUDA card, or call
them again and again to see whether they give the same bits every time.

Each variant is ``name=old>>new||old>>new...``: text replacements applied to
a copy of ``sonar_tpu_torch/csrc/`` as ``torch_kernel_variants.py`` applies
them (its ``build``); every variant is built into a library of its own
under ``build/variants/<name>/`` and timed at ``TIMED`` (D 1024; [8, 16,
499, 64] in bf16 and fp32, [16, 16, 999, 64] in bf16), in turns (the
variants in order, then in reverse), beside its error against the plain
version. An empty spec (``base=``) is the source as it is. Ablations (a variant that
skips work) give wrong results by design: only their times mean anything.

    python3 scripts/torch_relpos_variants.py 'base=' \\
        'nowin=wgmma_bf16_m64n128k16_ss_kmajor(win,>>if (false) wgmma_bf16_m64n128k16_ss_kmajor(win,'

A variant may also be named by itself, without ``=``: one of ``PROBES``,
the variants kept for the repeat check below.

With ``--repeats N`` each variant is instead called N times on the same
bf16 inputs at the long shapes of ``REPEAT_SHAPES``, the memory its
distance table gets filled with NaN before every call; the script prints
how many calls differ from the first bit for bit, how many hold a
non-finite value, and the largest error against the plain version.
"""

from pathlib import Path
import subprocess
import sys

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402
from torch_kernel_variants import build, timed  # noqa: E402

from sonar_tpu_torch.nn.conformer import _trig_tables  # noqa: E402
from sonar_tpu_torch.ops import _build  # noqa: E402
from sonar_tpu_torch.ops.cuda import relpos_flash  # noqa: E402


# Pass 2 freeing its V slots with a cluster-scope release.
_CLUSTER_RELEASE = (
    r"        release(s);\n      }\n    }\n\n    // -- the two key halves"
    ">>"
    r"        __syncwarp();\n        if (lane < RT_C)\n"
    r'          asm volatile("{ .reg .b32 r; mapa.shared::cluster.u32 r, %0, %1; '
    r'mbarrier.arrive.release.cluster.shared::cluster.b64 _, [r]; }"'
    r' :: "r"(smem_u32(empty + s)), "r"(lane) : "memory");\n'
    r"      }\n    }\n\n    // -- the two key halves"
)
# Clusters of one block: every tile loaded whole by the block that reads it.
_NO_CLUSTER = "constexpr int RT_C = 2;>>constexpr int RT_C = 1;"
PROBES = {
    "cluster_release": _CLUSTER_RELEASE,
    "no_cluster": _NO_CLUSTER,
}


def inputs(b, h, s, dh, dtype, d=1024, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    q, k, v = (rand(b, h, s, dh) for _ in range(3))
    wr = rand(h, d, dh, scale=d ** -0.5)
    u, vb = rand(h, dh, scale=0.1), rand(h, dh, scale=0.1)
    si, ci, basis = _trig_tables(s, d, dtype, "cuda")
    lens = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lens[0] = s
    if b > 1:
        lens[-1] = 0  # a batch row whose every key is masked
    kb = torch.where(torch.arange(s, device="cuda")[None, :] < lens[:, None], 0.0,
                     torch.finfo(torch.float32).min)
    return q, k, v, wr, si, ci, basis, u, vb, kb.float()


# Timed: S 499 in bf16 and fp32, and a batch of the speech cell in bf16.
TIMED = ((8, 16, 499, 64, torch.bfloat16), (16, 16, 999, 64, torch.bfloat16),
         (8, 16, 499, 64, torch.float32))
REPEAT_SHAPES = ((1, 16, 2048, 64), (2, 16, 1999, 64), (8, 16, 1999, 64), (8, 16, 499, 64),
                 (1, 8, 2048, 128))


def repeats(libs, n: int) -> None:
    for b, h, s, dh in REPEAT_SHAPES:
        args = inputs(b, h, s, dh, torch.bfloat16)
        want = relpos_flash.relpos_flash_attention_v2_plain(*args).double()
        for name, lib in libs:
            _build._lib = lib
            first, differ, nonfinite, err = None, 0, 0, 0.0
            for _ in range(n):
                # The freed NaN block is what the wrapper's table gets next.
                torch.full((h, 2 * s - 1 + relpos_flash.TABLE_PAD, dh), float("nan"),
                           dtype=torch.bfloat16, device="cuda")
                got = relpos_flash.relpos_flash_attention_v2(*args)
                nonfinite += not bool(torch.isfinite(got).all())
                if first is None:
                    first = got
                elif not torch.equal(got, first):
                    differ += 1
                err = max(err, (got.double() - want).abs().max().item())
            print(f"[{b},{h},{s},{dh}] bf16 {name}: {n} calls, {differ} differ from the first, "
                  f"{nonfinite} non-finite, max abs error {err:.2e} (ref max "
                  f"{want.abs().max().item():.3g})", flush=True)
        del args, want


def main(argv) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    n_repeats = 0
    if argv[:1] == ["--repeats"]:
        n_repeats, argv = int(argv[1]), argv[2:]
    variants = dict(v.split("=", 1) if "=" in v else (v, PROBES[v]) for v in argv)
    libs = {name: build(name, spec) for name, spec in variants.items()}
    libs = [(name, lib) for name, lib in libs.items() if lib is not None]
    if n_repeats:
        repeats(libs, n_repeats)
        return
    for b, h, s, dh, dtype in TIMED:
        args = inputs(b, h, s, dh, dtype)
        want = relpos_flash.relpos_flash_attention_v2_plain(*args).double()
        for name, lib in libs + libs[::-1]:
            _build._lib = lib
            got = relpos_flash.relpos_flash_attention_v2(*args).double()
            err = (got - want).abs().max().item()
            ms = timed(lambda: relpos_flash.relpos_flash_attention_v2(*args))
            print(f"[{b},{h},{s},{dh}] {dtype} {name}: {ms:.4f} ms, max abs error {err:.2e}",
                  flush=True)
        del args, want


if __name__ == "__main__":
    main(sys.argv[1:])
