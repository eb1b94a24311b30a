"""Bit-for-bit check of two builds of the CUDA kernels on the card: this
checkout's `simulst_tpu_torch/csrc/` against that of another git revision.

The revision's sources (read with `git show REV:simulst_tpu_torch/csrc/...`)
are built, with the same nvcc flags, into
`simulst_tpu_torch/_build/bitcheck_<REV>/` beside the current build; both
libraries are loaded, the same C entries of both run on the same seeded
inputs, and each output is compared with torch.equal:

  simulst_ffn            y of ln_res 1 (fused_ln_ffn_res) and ln_res 0
                         (fused_ffn), this checkout's entry called twice,
                         on its fused row-block path and on its tiled path
                         (each call with its own build's C signature: a
                         revision without the tiled path takes no xn / h);
                         fp32 and bf16, gelu and relu, dropout 0 and 0.1, at
                         1, 24, 40, 300, 3072, 4,133, 8192 and 12,288 rows
                         (D 256, FFN 2048)
  simulst_ffn_bwd        dx, dW1, db1, dW2, db2 through ops/ffn.py's
                         wrapper, at the same cases
  simulst_ln_ffn_bwd     dx, dgamma, dbeta, dW1, db1, dW2, db2 through the
                         wrapper; fp32 and bf16, gelu and relu, dropout 0
                         and 0.1, at 1, 300, 4,133 and 12,288 rows
  simulst_cif_integrate  out and delays at the shapes of
                         tests/test_torch_port_cuda.py's CIF cases (a
                         revision whose entry takes cprev gets csum - alpha
                         from torch, one rounding, as its wrapper computed
                         it)

With --time it also times both builds in one process, in turns (revision,
this checkout, this checkout, revision), with CUDA events: the LN-FFN
forward at 12,288 rows (gelu, rate 0.1) and the FFN forward at 8192 rows
(relu, rate 0.1), the revision's C entry against this checkout's on the
path its wrapper takes; the FFN backward at 8192 rows (relu, rate 0.1)
and the LN-FFN backward at 12,288 rows (gelu, rate 0.1) through the
wrappers; the CIF C entry at (32, 256, 256, 72).  Then each build's
device time per call by kernel (torch.profiler), and this checkout's
forward on both of its paths from 24 to 3072 rows (fp32, dropout 0: the
serving and offline row counts), which places ops/ffn.py's TILED_MIN_ROWS.

On a machine with the card, from the repository root:

    python3 tools/kernel_bitcheck.py --rev REV [--time]

A copy without git (the card machine's) reads the sources that
`python3 tools/kernel_bitcheck.py --rev REV --export` wrote there
beforehand, in a git checkout, without building.  Prints the card's name
and power limit, one JSON line per case and a summary line; exits 1 if
any output differs.
"""
import argparse
import concurrent.futures
import contextlib
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = "simulst_tpu_torch/csrc"
LN_ROWS = (1, 300, 4133, 12288)
FFN_ROWS = (1, 24, 40, 300, 3072, 4133, 8192, 12288)
CROSSOVER_ROWS = (24, 40, 128, 256, 384, 512, 544, 768, 1024, 3072)
# (label, B, S, C, T, beta, how alpha is made)
CIF_CASES = (
    ("cif-train (32,256,256,65)", 32, 256, 256, 65, 1.0, "sigmoid"),
    ("train (32,256,256,72)", 32, 256, 256, 72, 1.0, "sigmoid"),
    ("stream (1,17,256,19)", 1, 17, 256, 19, 1.0, "sigmoid"),
    ("ragged (4,29,256,1)", 4, 29, 256, 1, 1.0, "sigmoid"),
    ("long (2,512,256,300)", 2, 512, 256, 300, 1.0, "sigmoid"),
    ("beta 0.8 (8,256,256,80)", 8, 256, 256, 80, 0.8, "sigmoid"),
    ("C 300 (3,40,300,12)", 3, 40, 300, 12, 1.0, "sigmoid"),
    ("three buckets (4,64,256,40)", 4, 64, 256, 40, 1.0, "wide"),
    ("T > S (2,12,256,40)", 2, 12, 256, 40, 1.0, "t_over_s"),
    ("zero runs (4,128,256,48)", 4, 128, 256, 48, 1.0, "zero_runs"),
    ("S 1100 (2,1100,256,300)", 2, 1100, 256, 300, 1.0, "sigmoid"),
    ("C 130 (3,40,130,12)", 3, 40, 130, 12, 1.0, "sigmoid"),
    ("csum dips one ulp (2,64,256,24)", 2, 64, 256, 24, 1.0, "dip"),
)


def cif_inputs(torch, b, s, c, how, seed):
    """(x, alpha, csum) on the card, seeded: alpha = sigmoid(noise) with
    row 0's second half zero (padding), as the card tests make it, or one
    of the stressed forms of `how`."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, c, generator=g)
    alpha = torch.sigmoid(torch.randn(b, s, generator=g))
    alpha[0, s // 2:] = 0.0
    if how == "wide":            # frames wider than two buckets
        alpha[:, 3::7] = 2.0 + torch.rand(b, len(range(3, s, 7)), generator=g)
    elif how == "t_over_s":      # every frame spans about three buckets
        alpha = 2.5 + torch.rand(b, s, generator=g)
    elif how == "zero_runs":     # zero-weight runs inside rows, a zero row
        alpha[:, 10:30] = 0.0
        alpha[:, 70:75] = 0.0
        alpha[-1] = 0.0
    x, alpha = x.cuda(), alpha.cuda()
    csum = torch.cumsum(alpha, dim=1)
    if how == "dip":             # csum falls by one ulp at a few frames
        for row, k in ((0, 5), (1, 20), (1, 41)):
            csum[row, k] = torch.nextafter(csum[row, k - 1],
                                           torch.tensor(-1.0, device="cuda"))
    return x, alpha, csum


def export(rev, dest):
    """Write REV's csrc/*.cu and *.cuh into dest/csrc."""
    names = subprocess.run(["git", "ls-tree", "--name-only", f"{rev}:{CSRC}"],
                           cwd=ROOT, check=True, capture_output=True,
                           text=True).stdout.split()
    out = dest / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    for name in names:
        if name.endswith((".cu", ".cuh")):
            blob = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                                  cwd=ROOT, check=True,
                                  capture_output=True).stdout
            (out / name).write_bytes(blob)
    return out


@contextlib.contextmanager
def library_of(_build, lib):
    """Route the wrappers' launches to `lib`."""
    saved = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = saved


def ln_ffn_inputs(torch, rows, dtype, seed):
    """x, (ln_g, ln_b, w1, b1, w2, b2), dy on the card, seeded."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).cuda().to(dtype)

    x, dy = randn(rows, 256), randn(rows, 256)
    ws = (1 + randn(256, scale=0.1), randn(256, scale=0.1),
          randn(256, 2048, scale=0.03), randn(2048, scale=0.02),
          randn(2048, 256, scale=0.03), randn(256, scale=0.02))
    return x, ws, dy


def ffn_entry(torch, _build, ffn, lib, takes_scratch, ln_res, act, x, ws,
              rate, tiled):
    """simulst_ffn of `lib` bound to its arguments and called once, with
    its build's signature (takes_scratch: xn and h, null for the fused
    path); `.y` is the output.  A call costs the host little beside the
    launch, so that CUDA events time the kernels."""
    n = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    plan = ffn.slice_plan(n, 2048, ffn._sm_count(x.device.index))
    y = torch.empty_like(x)
    partial = torch.empty(plan.splits, n, 256, **f32)
    xn = torch.empty(n, 256, **f32) if tiled and ln_res else None
    h = torch.empty(n, 2048, **f32) if tiled else None
    scratch = (ffn._ptr(xn), ffn._ptr(h)) if takes_scratch else ()
    call = functools.partial(
        lib.simulst_ffn, _build.dtype_code(x), ln_res,
        ffn.ACTIVATION_CODES[act], x.data_ptr(),
        *(w.data_ptr() for w in ws), y.data_ptr(), partial.data_ptr(),
        *scratch, n, 256, 2048, plan.splits,
        *ffn._dropout_sites(rate, rate, 29), _build.stream_of(x))
    call.y, call.keep = y, (partial, xn, h)
    if call():
        raise RuntimeError("simulst_ffn: CUDA error")
    return call


def device_ms(torch, fn, calls):
    """Device time per call of fn() by kernel, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    def short(key):
        for noise in ("void ", "simulst::", "(anonymous namespace)::"):
            key = key.replace(noise, "")
        return key[:200]

    return {short(e.key): e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rev", required=True, help="git revision to compare")
    ap.add_argument("--export", action="store_true",
                    help="only write the revision's sources under _build/")
    ap.add_argument("--time", action="store_true",
                    help="also time both builds in turns")
    args = ap.parse_args()

    from simulst_tpu_torch.ops import _build
    ref_dir = _build.BUILD_DIR / f"bitcheck_{args.rev}"
    if args.export or not (ref_dir / "csrc").is_dir():
        ref_csrc = export(args.rev, ref_dir)
    else:
        ref_csrc = ref_dir / "csrc"
    if args.export:
        print(f"wrote {ref_csrc}")
        return 0

    import torch
    import chip_smoke as cs
    from simulst_tpu_torch.ops import ffn

    if not torch.cuda.is_available():
        print("kernel_bitcheck: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(cs.gpu_name_and_power_limit(), flush=True)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        paths = [pool.submit(_build.build, *where) for where in
                 ((ref_csrc, ref_dir), (_build.CSRC, _build.BUILD_DIR))]
        ref_path, cur_path = (p.result() for p in paths)
    libs = {"rev": _build.open_library(ref_path),
            "this": _build.open_library(cur_path)}
    ref_takes_cprev = "const void* cprev" in \
        (ref_csrc / "cif.cu").read_text()
    ref_takes_scratch = "void* xn, void* h" in \
        (ref_csrc / "ffn.cu").read_text()
    if not ref_takes_scratch:    # simulst_ffn before the tiled path
        _P, _I = _build._P, _build._I
        libs["rev"].simulst_ffn.argtypes = (
            [_I] * 3 + [_P] * 9 + [_I] * 4 + _build._DROP
            + _build._DROP[1:] + [_P])
    summary = {}

    def report(entry, case, equal):
        ok = all(equal.values())
        s = summary.setdefault(entry, {"cases": 0, "all_equal": True})
        s["cases"] += 1
        s["all_equal"] = s["all_equal"] and ok
        print(json.dumps({"entry": entry, "case": case, "equal": equal}),
              flush=True)

    def ffn_fwd(key, ln_res, act, x, ws, rate, tiled):
        takes = ref_takes_scratch if key == "rev" else True
        return ffn_entry(torch, _build, ffn, libs[key], takes, ln_res, act,
                         x, ws, rate, tiled)

    dtypes = (torch.float32, torch.bfloat16)
    names = ("dx", "dw1", "db1", "dw2", "db2")
    for dtype in dtypes:
        for act in ("gelu", "relu"):
            for rate in (0.0, 0.1):
                for rows in FFN_ROWS:
                    case = f"{str(dtype)[6:]} {act} rate {rate} rows {rows}"
                    x, ws, dy = ln_ffn_inputs(torch, rows, dtype, rows + 1)
                    for ln_res in (1, 0):
                        want = ffn_fwd("rev", ln_res, act, x, ws, rate,
                                       ref_takes_scratch).y
                        got = {path: ffn_fwd("this", ln_res, act, x, ws, rate,
                                             path == "tiled").y
                               for path in ("fused", "tiled")}
                        torch.cuda.synchronize()
                        report(f"simulst_ffn ln_res {ln_res}", case,
                               {f"y {p}": torch.equal(want, y)
                                for p, y in got.items()})
                    outs = {}
                    for key, lib in libs.items():
                        with library_of(_build, lib):
                            outs[key] = ffn.fused_ffn_backward(
                                x, *ws[2:5], dy, act, rate, rate, 29)
                    torch.cuda.synchronize()
                    report("simulst_ffn_bwd", case,
                           {n: torch.equal(a, b) for n, a, b in
                            zip(names, outs["rev"], outs["this"])})

    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for dtype in dtypes:
        for act in ("gelu", "relu"):
            for rate in (0.0, 0.1):
                for rows in LN_ROWS:
                    x, ws, dy = ln_ffn_inputs(torch, rows, dtype, rows)
                    outs = {}
                    for key, lib in libs.items():
                        with library_of(_build, lib):
                            outs[key] = ffn.fused_ln_ffn_res_backward(
                                x, *ws[:5], dy, act, rate, rate, 29)
                    torch.cuda.synchronize()
                    report("simulst_ln_ffn_bwd",
                           f"{str(dtype)[6:]} {act} rate {rate} rows {rows}",
                           {n: torch.equal(a, b) for n, a, b in
                            zip(names, outs["rev"], outs["this"])})

    def cif_entry(lib, x, alpha, csum, t, beta, out, delays):
        """The C entry bound to its arguments: a call costs the host little
        beside the launch, so that CUDA events time the kernel."""
        b, s, c = x.shape
        third = csum - alpha if lib is libs["rev"] and ref_takes_cprev \
            else alpha
        call = functools.partial(
            lib.simulst_cif_integrate, x.data_ptr(), csum.data_ptr(),
            third.data_ptr(), out.data_ptr(), delays.data_ptr(), b, s, t, c,
            float(beta), _build.stream_of(x))
        call.keep = third
        if call():
            raise RuntimeError("simulst_cif_integrate: CUDA error")
        return call

    for i, (label, b, s, c, t, beta, how) in enumerate(CIF_CASES):
        x, alpha, csum = cif_inputs(torch, b, s, c, how, 100 + i)
        outs = {}
        for key, lib in libs.items():
            out = torch.full((b, t, c), float("nan"), device="cuda")
            delays = torch.full((b, t), float("nan"), device="cuda")
            cif_entry(lib, x, alpha, csum, t, beta, out, delays)
            outs[key] = (out, delays)
        torch.cuda.synchronize()
        report("simulst_cif_integrate", label,
               {n: torch.equal(a, b_) for n, a, b_ in
                zip(("out", "delays"), outs["rev"], outs["this"])})

    if args.time:
        times = {}
        x, ws, dy = ln_ffn_inputs(torch, 12288, torch.float32, 12288)
        xm, wm, dym = ln_ffn_inputs(torch, 8192, torch.float32, 8192)
        xc, alpha, csum = cif_inputs(torch, 32, 256, 256, "sigmoid", 7)
        out = torch.empty(32, 72, 256, device="cuda")
        delays = torch.empty(32, 72, device="cuda")

        def entries(key):
            """The calls timed for one build: name -> fn()."""
            lib, tiled = libs[key], key == "this" or ref_takes_scratch

            def wrapped(fn, *a):
                def call():
                    with library_of(_build, lib):
                        fn(*a)
                return call
            return {
                "ln_ffn_fwd_ms": ffn_fwd(key, 1, "gelu", x, ws, 0.1, tiled),
                "ffn_fwd_ms": ffn_fwd(key, 0, "relu", xm, wm, 0.1, tiled),
                "ffn_bwd_ms": wrapped(ffn.fused_ffn_backward, xm, *wm[2:5],
                                      dym, "relu", 0.1, 0.1, 29),
                "ln_ffn_bwd_ms": wrapped(ffn.fused_ln_ffn_res_backward, x,
                                         *ws[:5], dy, "gelu", 0.1, 0.1, 29),
                "cif_c_entry_ms": cif_entry(lib, xc, alpha, csum, 72, 1.0,
                                            out, delays)}

        for key in ("rev", "this", "this", "rev"):
            times.setdefault(key, []).append(
                {name: cs.cuda_ms(fn, samples=5, runs=5)
                 for name, fn in entries(key).items()})
        print("times " + json.dumps(times), flush=True)
        for key in libs:
            print(f"device_ms {key} " + json.dumps(
                {name[:-3]: device_ms(torch, fn, calls=3)
                 for name, fn in entries(key).items()}), flush=True)
        crossover = {}
        for rows in CROSSOVER_ROWS:
            for ln_res, act in ((1, "gelu"), (0, "relu")):
                xs, wss, _ = ln_ffn_inputs(torch, rows, torch.float32, rows)
                crossover[f"ln_res {ln_res} rows {rows}"] = {
                    path: cs.cuda_ms(ffn_fwd("this", ln_res, act, xs, wss,
                                             0.0, path == "tiled"))
                    for path in ("fused", "tiled")}
        print("crossover_ms " + json.dumps(crossover), flush=True)

    ok = all(s["all_equal"] for s in summary.values())
    print(json.dumps({"bitcheck": {"rev": args.rev, **summary}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
