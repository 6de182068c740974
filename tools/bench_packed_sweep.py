"""Time the float32 Helmholtz solve with each DST backend -- XLA's FFT
and the packed radix-split sine-matrix matmul (helmholtz.BoxHelmholtz
transform='matmul') -- at the production interior widths, plus the
cyclic channel's y transform. The model's FFT default rests on this
sweep (solver/helmholtz.py, PERF.md).

Run on the GPU:
    python tools/bench_packed_sweep.py [--sizes 575,959,1919,4799]
        [--splits 240] [--channel 4609x577] [--reps 5] [--inner 4]
Prints one line per grid: ms per 3-mode solve for each backend.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

NM = 3
RDM2 = np.array([0.0, 6.25e-10, 2.5e-9])


def timed(solver, x, reps, inner):
    """Median ms per solve over `reps` jitted scans of `inner` solves."""
    @jax.jit
    def loop(x):
        def body(c, _):
            return solver.solve(c), None
        out, _ = lax.scan(body, x, None, length=inner)
        return out

    jax.block_until_ready(loop(x))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(x))
        ts.append((time.perf_counter() - t0) / inner)
    return 1e3 * float(np.median(ts))


def box_row(n, splits, reps, inner):
    from qgcm_tpu.solver import helmholtz as hh
    nxp = n + 2
    x = jax.random.normal(jax.random.PRNGKey(0), (NM, nxp, nxp),
                          jnp.float32)
    fft = hh.make_box_helmholtz(nxp, nxp, 5e3, 5e3, RDM2,
                                dtype=jnp.float32, transform="fft")
    row = [f"box n={n:5d}", f"fft {timed(fft, x, reps, inner):8.3f}"]
    # restore the module global afterwards: a solver built later in
    # this process must see the split depth its _split_perm assumed
    orig_split = hh._MM_SPLIT_MIN
    try:
        for sm in splits:
            hh._MM_SPLIT_MIN = sm
            mm = hh.make_box_helmholtz(nxp, nxp, 5e3, 5e3, RDM2,
                                       dtype=jnp.float32,
                                       transform="matmul")
            row.append(f"matmul[split {sm}] "
                       f"{timed(mm, x, reps, inner):8.3f}")
    finally:
        hh._MM_SPLIT_MIN = orig_split
    return "   ".join(row)


def channel_row(nxp, nyp, reps, inner):
    from qgcm_tpu.solver import helmholtz as hh
    x = jax.random.normal(jax.random.PRNGKey(0), (NM, nyp, nxp),
                          jnp.float32)
    row = [f"channel {nxp}x{nyp}"]
    for yt in ("fft", "matmul"):
        s = hh.make_cyclic_helmholtz(nxp, nyp, 5e3, 5e3, RDM2,
                                     dtype=jnp.float32, ytransform=yt)
        row.append(f"y-{yt} {timed(s, x, reps, inner):8.3f}")
    return "   ".join(row)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="575,959,1919,4799")
    ap.add_argument("--splits", default="240")
    ap.add_argument("--channel", default="4609x577")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--inner", type=int, default=4)
    args = ap.parse_args(argv)
    d = jax.devices()[0]
    print(f"{d.platform} {d.device_kind}: ms per {NM}-mode f32 solve "
          f"(median of {args.reps} x {args.inner})", flush=True)
    for n in (int(s) for s in args.sizes.split(",") if s):
        print(box_row(n, [int(s) for s in args.splits.split(",")],
                      args.reps, args.inner), flush=True)
    if args.channel:
        nxp, nyp = (int(v) for v in args.channel.split("x"))
        print(channel_row(nxp, nyp, args.reps, args.inner), flush=True)


if __name__ == "__main__":
    main()
