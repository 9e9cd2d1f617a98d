#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device and build — the card's name and power limit, then both CUDA
   kernels compiled with nvcc for sm_90a from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together);
2. kernels against their plain PyTorch versions on the card — the case
   grids of the JAX package's kernel tests and the serving path's shapes,
   float32 at 2e-3 and bfloat16 at 2e-2, with every dead KV line (past
   the causal extent or kv_len, below the window) poisoned with NaN;
   then a reduced float32 model served on the card (kernels) against the
   same model on the CPU (plain versions): teacher-forced logits at 2e-3
   and greedy engine outputs token for token;
3. the main path — ``repro_torch.launch.serve`` at full width: edge
   qwen2-1.5b (28 layers) and cloud mistral-large-123b (published width,
   2 layers), bf16, random weights from seeds, router warm start, 6 gpqa
   queries through ``ServingRuntime`` with ``HybridFlowPolicy``; every
   query must complete, both engines must prefill and decode, and each
   engine's prefill chunks and decode ticks are counted as they run: every
   one must launch its kernel once per layer, every launch must fall in
   one of them, and the plain versions never run;
4. times at the serving shapes — kernel, plain version and
   ``scaled_dot_product_attention`` (a yardstick only: the port never
   calls it), beside the least time the card could take.

The last two lines of standard output are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate and bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TOL = {"float32": 2e-3, "bfloat16": 2e-2}

RAGGED_CASES = [
    # (G, S, W, H, KV, hd, window) — tests/test_ragged_prefill_kernel.py
    (2, 16, 64, 4, 2, 32, None),
    (3, 32, 128, 8, 8, 64, None),
    (1, 8, 32, 4, 1, 32, 16),
    (4, 24, 96, 2, 2, 16, None),
    (2, 64, 64, 2, 1, 128, 32),
    (5, 7, 40, 3, 1, 16, None),
]
BATCHED_DECODE_CASES = [
    # (B, M, H, KV, hd, window) — tests/test_batched_decode_kernel.py
    (2, 64, 4, 2, 32, None),
    (3, 130, 8, 8, 64, None),
    (1, 512, 2, 1, 128, None),
    (4, 96, 12, 2, 64, None),
    (2, 64, 4, 2, 32, 16),
    (3, 100, 6, 1, 32, 48),
]
# the serving path's shapes: prefill chunks of 128 over up to 512 pooled
# lines, decode over 512-line slots; edge qwen2-1.5b (12 query heads over 2
# KV heads) and cloud mistral-large-123b (96 over 8), head dim 128
MAIN_RAGGED = {"edge": (2, 128, 512, 12, 2, 128, None),
               "cloud": (4, 128, 512, 96, 8, 128, None)}
MAIN_DECODE = {"edge": (2, 512, 12, 2, 128, None),
               "cloud": (4, 512, 96, 8, 128, None)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# phase 2 helpers
# ---------------------------------------------------------------------------

def ragged_inputs(torch, case, dtype, gen, *, full_rows=False):
    G, S, W, H, KV, hd, _ = case
    dev = "cuda"
    q = torch.randn(G, S, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(G, W, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(G, W, KV, hd, generator=gen, device=dev).to(dtype)
    if full_rows:      # serving-shaped: full chunks at staggered offsets
        take = torch.full((G,), S, dtype=torch.int32, device=dev)
        pos0 = torch.tensor([(W - S) * g // max(G - 1, 1) for g in range(G)],
                            dtype=torch.int32, device=dev)
    else:              # ragged: take in [0, S], pos0 in [0, W - take]
        take = torch.randint(0, S + 1, (G,), generator=gen, device=dev,
                             dtype=torch.int32)
        u = torch.rand(G, generator=gen, device=dev)
        pos0 = (u * (W + 1 - take)).to(torch.int32)
    return q, k, v, pos0, take


def poison_ragged(torch, q, k, v, pos0, take, window):
    """NaN into every query row past take and every KV line no valid row
    may read: past pos0 + take, and below the window of the first row."""
    q, k, v = q.clone(), k.clone(), v.clone()
    for g, (p0, tk) in enumerate(zip(pos0.tolist(), take.tolist())):
        q[g, tk:] = float("nan")
        k[g, p0 + tk:] = float("nan")
        v[g, p0 + tk:] = float("nan")
        if window is not None:
            lo = max(0, p0 - window + 1)
            k[g, :lo] = float("nan")
            v[g, :lo] = float("nan")
    return q, k, v


def decode_inputs(torch, case, dtype, gen, *, kv_len=None):
    B, M, H, KV, hd, _ = case
    dev = "cuda"
    q = torch.randn(B, 1, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, M, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, M, KV, hd, generator=gen, device=dev).to(dtype)
    if kv_len is None:
        kv_len = torch.randint(0, M + 1, (B,), generator=gen, device=dev,
                               dtype=torch.int32)
    return q, k, v, kv_len


def poison_decode(torch, k, v, kv_len, window):
    k, v = k.clone(), v.clone()
    for b, n in enumerate(kv_len.tolist()):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
        if window is not None:
            k[b, :max(0, n - window)] = float("nan")
            v[b, :max(0, n - window)] = float("nan")
    return k, v


def max_err(torch, got, want, tol, what):
    """Max abs error; raises if ``got`` is not finite or not within
    ``tol`` (absolute plus relative, as numpy's allclose)."""
    got, want = got.float(), want.float()
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    diff = (got - want).abs()
    require(bool((diff <= tol + tol * want.abs()).all()),
            f"{what}: max abs err {diff.max().item():.3g} over tol {tol}")
    return diff.max().item()


def check_kernels(torch):
    from repro_torch.kernels import batched_decode_attention as BD
    from repro_torch.kernels import ragged_prefill_attention as RP
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"ragged_prefill_attention": 0.0, "batched_decode_attention": 0.0}
    n = 0
    for dname, tol in TOL.items():
        dtype = getattr(torch, dname)
        cases = [(c, False) for c in RAGGED_CASES] + \
            [(c, full) for c in MAIN_RAGGED.values() for full in (0, 1)]
        for case, full in cases:
            window = case[-1]
            q, k, v, pos0, take = ragged_inputs(torch, case, dtype, gen,
                                                full_rows=bool(full))
            want = RP.ragged_prefill_attention_plain(q, k, v, pos0, take,
                                                     window=window)
            qp, kp, vp = poison_ragged(torch, q, k, v, pos0, take, window)
            for qq, kk, vv, tag in ((q, k, v, "clean"),
                                    (qp, kp, vp, "NaN-poisoned")):
                got = RP.ragged_prefill_attention(qq, kk, vv, pos0, take,
                                                  window=window)
                torch.cuda.synchronize()
                e = max_err(torch, got, want, tol,
                            f"ragged {case} {dname} {tag}")
                n += 1
                if case in MAIN_RAGGED.values() and dname == "bfloat16":
                    errs["ragged_prefill_attention"] = max(
                        errs["ragged_prefill_attention"], e)
        cases = BATCHED_DECODE_CASES + list(MAIN_DECODE.values())
        for case in cases:
            window = case[-1]
            q, k, v, kv_len = decode_inputs(torch, case, dtype, gen)
            kv_len[0] = 0                    # an empty slot: exact zeros
            want = BD.batched_decode_attention_plain(q, k, v, kv_len,
                                                     window=window)
            kp, vp = poison_decode(torch, k, v, kv_len, window)
            for kk, vv, tag in ((k, v, "clean"), (kp, vp, "NaN-poisoned")):
                got = BD.batched_decode_attention(q, kk, vv, kv_len,
                                                  window=window)
                torch.cuda.synchronize()
                e = max_err(torch, got, want, tol,
                            f"decode {case} {dname} {tag}")
                require(bool((got[0] == 0).all()),
                        f"decode {case}: kv_len=0 slot is not exact zeros")
                n += 1
                if case in MAIN_DECODE.values() and dname == "bfloat16":
                    errs["batched_decode_attention"] = max(
                        errs["batched_decode_attention"], e)
    print(f"kernels vs plain versions: {n} comparisons passed "
          f"(main-path bf16 max abs err {errs})")
    return errs


def check_small_model(torch):
    """A reduced float32 model on the card (CUDA kernels) against the same
    model on the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("qwen2-1.5b").reduced()
    gpu = M.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    cpu = _to(gpu, "cpu")
    caches = {d: M.init_cache(cfg, 3, 64, dtype=torch.float32, device=d)
              for d in ("cuda", "cpu")}
    params = {"cuda": gpu, "cpu": cpu}
    gen = torch.Generator().manual_seed(0)
    steps = [([2, 0, 1], [0, 0, 0], [8, 5, 3], 8),
             ([2, 1], [8, 3], [6, 8], 16)]
    err = 0.0
    with torch.no_grad():
        for slots, pos0, take, kv_width in steps:
            tokens = torch.randint(4, cfg.vocab_size, (len(slots), 8),
                                   generator=gen)
            out = {}
            for d in ("cuda", "cpu"):
                ints = [torch.tensor(x, dtype=torch.int32, device=d)
                        for x in (slots, pos0, take)]
                out[d], _ = M.serve_prefill_chunk(
                    params[d], cfg, tokens.to(d), caches[d], *ints,
                    kv_width=kv_width)
            err = max(err, max_err(torch, out["cuda"].cpu(), out["cpu"],
                                   2e-3, "reduced prefill logits"))
        pos = [63, 11, 14]
        for _ in range(3):
            token = torch.randint(4, cfg.vocab_size, (3, 1), generator=gen)
            out = {}
            for d in ("cuda", "cpu"):
                out[d], _ = M.serve_decode(
                    params[d], cfg, token.to(d),
                    torch.tensor(pos, dtype=torch.int32, device=d), caches[d])
            err = max(err, max_err(torch, out["cuda"].cpu(), out["cpu"],
                                   2e-3, "reduced decode logits"))
            pos = [pos[0]] + [p + 1 for p in pos[1:]]
        for key in ("k", "v"):
            err = max(err, max_err(torch, caches["cuda"][key].cpu(),
                                   caches["cpu"][key], 2e-3, "reduced cache"))
    prompts = ["You are a careful assistant. Always reason step by step. "
               + t for t in ("part one", "part two", "the third part")]
    outs = {}
    for d in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params[d], batch_slots=2, max_len=96,
                            prefill_chunk=8, device=d)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_done()
        outs[d] = [r.output_ids for r in reqs]
    require(outs["cuda"] == outs["cpu"],
            f"reduced greedy outputs differ: {outs}")
    print(f"reduced qwen2-1.5b f32, card vs CPU: logits/cache max abs err "
          f"{err:.3g}, greedy outputs identical ({outs['cuda']})")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def run_main_path(torch):
    from repro_torch.kernels import batched_decode_attention as BD
    from repro_torch.kernels import ragged_prefill_attention as RP
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ServingEngine

    def counts():
        return (RP.ragged_prefill_attention.launches,
                BD.batched_decode_attention.launches)

    # each engine's prefill chunks and decode ticks, with the launches of
    # both kernels that each one made: (engine id, step kind) -> deltas
    per_call = {}

    def measured(kind, launch):
        def wrapper(self):
            before = counts()
            out = launch(self)
            if out is not None:
                per_call.setdefault((id(self), kind), []).append(
                    tuple(a - b for a, b in zip(counts(), before)))
            return out
        return wrapper

    args = serve.parse_args(["--queries", "6", "--benchmark", "gpqa"])
    originals = (ServingEngine._prefill_launch, ServingEngine._decode_launch)
    ServingEngine._prefill_launch = measured("prefill", originals[0])
    ServingEngine._decode_launch = measured("decode", originals[1])
    try:
        for fn in (RP.ragged_prefill_attention, BD.batched_decode_attention):
            fn.launches = 0
        RP.ragged_prefill_attention_plain.calls = 0
        BD.batched_decode_attention_plain.calls = 0
        t0 = time.perf_counter()
        report, edge, cloud = serve.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(zip(("ragged_prefill_attention",
                             "batched_decode_attention"), counts()))
        plain = (RP.ragged_prefill_attention_plain.calls,
                 BD.batched_decode_attention_plain.calls)
    finally:
        ServingEngine._prefill_launch, ServingEngine._decode_launch = \
            originals

    require(report.n == 6, f"{report.n} of 6 queries reported")
    require(all(r.results and len(r.results) == len(r.offload)
                for r in report.results), "a query left subtasks unfinished")
    # per engine and step kind, the launches of each call, as measured
    per_step = {"ragged_prefill_attention": {},
                "batched_decode_attention": {}}
    for name, eng in (("edge", edge), ("cloud", cloud)):
        pre = per_call.get((id(eng), "prefill"), [])
        dec = per_call.get((id(eng), "decode"), [])
        require(len(pre) == eng.stats["prefill_calls"] > 0
                and len(dec) == eng.stats["steps"] > 0,
                f"{name} engine did not both prefill and decode: "
                f"{eng.stats}, {len(pre)} prefill / {len(dec)} decode calls")
        pre_ragged = sorted({r for r, _ in pre})
        dec_decode = sorted({d for _, d in dec})
        require(pre_ragged == [eng.cfg.n_layers]
                and all(d == 0 for _, d in pre),
                f"{name}: ragged launches per prefill chunk {pre_ragged}, "
                f"want one per layer ({eng.cfg.n_layers})")
        require(dec_decode == [eng.cfg.n_layers]
                and all(r == 0 for r, _ in dec),
                f"{name}: decode launches per tick {dec_decode}, want one "
                f"per layer ({eng.cfg.n_layers})")
        per_step["ragged_prefill_attention"][name] = {
            "per_prefill_chunk": pre_ragged[0], "prefill_chunks": len(pre)}
        per_step["batched_decode_attention"][name] = {
            "per_decode_tick": dec_decode[0], "decode_ticks": len(dec)}
    # every launch of the run happened inside one of those calls
    for i, kernel in enumerate(launches):
        attributed = sum(c[i] for calls in per_call.values() for c in calls)
        require(attributed == launches[kernel],
                f"{kernel}: {launches[kernel]} launches, {attributed} inside "
                f"engine prefill/decode calls")
    require(plain == (0, 0), f"plain versions ran on the main path: {plain}")
    tokens = edge.stats["tokens_out"] + cloud.stats["tokens_out"]
    routes = ["".join("C" if r.offload[s] else "e" for s in sorted(r.offload))
              for r in report.results]
    print(f"main path: {report.n} queries, routes {routes}, {tokens} tokens "
          f"out (edge {edge.stats['tokens_out']}, cloud "
          f"{cloud.stats['tokens_out']}), wall {wall:.2f} s; launches "
          f"{launches}, per engine step as measured {per_step}; "
          f"plain-version calls {plain}")
    return launches, per_step


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def time_ms(torch, fn, n_sets, iters=30):
    """Mean ms per call over ``iters`` calls, cycling ``n_sets`` input sets
    so each call reads its inputs from HBM rather than from L2."""
    for i in range(n_sets):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ragged_work(pos0, take, S, H, KV, hd, elem):
    """Bytes and flops this call needs: q in, out, and each row's K/V
    lines up to its causal extent once; 4*hd flops per (query head, key)."""
    lines = sum(p + t for p, t in zip(pos0, take))
    pairs = sum(t * p + t * (t + 1) // 2 for p, t in zip(pos0, take))
    nbytes = (2 * len(pos0) * S * H * hd + 2 * lines * KV * hd) * elem \
        + 8 * len(pos0)
    return nbytes, 4 * hd * H * pairs


def decode_work(kv_len, H, KV, hd, elem):
    lines = sum(kv_len)
    nbytes = (2 * len(kv_len) * H * hd + 2 * lines * KV * hd) * elem \
        + 4 * len(kv_len)
    return nbytes, 4 * hd * H * lines


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(torch, launches, per_step, errs):
    import torch.nn.functional as F
    from repro_torch.kernels import batched_decode_attention as BD
    from repro_torch.kernels import ragged_prefill_attention as RP
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    n_sets = 8                       # 8 x 8 MB of K/V: more than the L2
    rows = []
    for engine in ("edge", "cloud"):
        case = MAIN_RAGGED[engine]
        G, S, W, H, KV, hd, _ = case
        sets = [ragged_inputs(torch, case, dt, gen, full_rows=True)
                for _ in range(n_sets)]
        lib_sets = []
        for q, k, v, pos0, take in sets:
            qpos = pos0[:, None] + torch.arange(S, device="cuda")
            mask = torch.arange(W, device="cuda")[None, None] <= qpos[..., None]
            lib_sets.append((q.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(), mask[:, None]))
        pos0_l, take_l = sets[0][3].tolist(), sets[0][4].tolist()
        nbytes, flops = ragged_work(pos0_l, take_l, S, H, KV, hd, 2)
        t_bound, by = bound(nbytes, flops)
        ms = time_ms(torch, lambda i: RP.ragged_prefill_attention(*sets[i]),
                     n_sets)
        plain_ms = time_ms(torch, lambda i: RP.ragged_prefill_attention_plain(
            *sets[i]), n_sets, iters=5)
        lib_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
            lib_sets[i][0], lib_sets[i][1], lib_sets[i][2],
            attn_mask=lib_sets[i][3], enable_gqa=True), n_sets)
        rows.append((engine, {
            "name": "ragged_prefill_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "ragged_prefill_attention.cu",
            "replaces": "src/repro/kernels/ragged_prefill_attention.py:84",
            "launches": launches["ragged_prefill_attention"],
            "launches_per_step": per_step["ragged_prefill_attention"],
            "max_abs_err": errs["ragged_prefill_attention"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bound,
            "bound_by": by, "library_ms": lib_ms,
            "shape": f"{engine} G={G} S={S} W={W} H={H} KV={KV} hd={hd} "
                     f"pos0={pos0_l} take={take_l} bf16"}))

        case = MAIN_DECODE[engine]
        B, M, H, KV, hd, _ = case
        kv_len = torch.tensor([(M - 1) * (b + 1) // B for b in range(B)],
                              dtype=torch.int32, device="cuda")
        sets = [decode_inputs(torch, case, dt, gen, kv_len=kv_len)
                for _ in range(n_sets)]
        mask = (torch.arange(M, device="cuda")[None] < kv_len[:, None])
        lib_sets = [(q.transpose(1, 2).contiguous(),
                     k.transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous(), mask[:, None, None])
                    for q, k, v, _ in sets]
        nbytes, flops = decode_work(kv_len.tolist(), H, KV, hd, 2)
        t_bound, by = bound(nbytes, flops)
        ms = time_ms(torch, lambda i: BD.batched_decode_attention(*sets[i]),
                     n_sets)
        plain_ms = time_ms(torch, lambda i: BD.batched_decode_attention_plain(
            *sets[i]), n_sets, iters=10)
        lib_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
            lib_sets[i][0], lib_sets[i][1], lib_sets[i][2],
            attn_mask=lib_sets[i][3], enable_gqa=True), n_sets)
        rows.append((engine, {
            "name": "batched_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "batched_decode_attention.cu",
            "replaces": "src/repro/kernels/batched_decode_attention.py:56",
            "launches": launches["batched_decode_attention"],
            "launches_per_step": per_step["batched_decode_attention"],
            "max_abs_err": errs["batched_decode_attention"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bound,
            "bound_by": by, "library_ms": lib_ms,
            "shape": f"{engine} B={B} M={M} H={H} KV={KV} hd={hd} "
                     f"kv_len={kv_len.tolist()} bf16"}))
    for engine, row in rows:
        print(f"timing {row['name']} [{row['shape']}]: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
    # the kernels line carries the cloud engine's shapes (GQA group of 12)
    return [row for engine, row in rows if engine == "cloud"]


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are missing under {SRC}")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs the "
             "card")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: device and build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(smi.splitlines()[0])
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {len(built)} kernels compiled in "
          f"{time.perf_counter() - t0:.1f} s {built}")

    # phase 2: kernels against their plain versions, small model vs CPU
    errs = check_kernels(torch)
    check_small_model(torch)

    # phase 3: the main path at full width
    launches, per_step = run_main_path(torch)

    # phase 4: times at the serving shapes
    kernels = time_kernels(torch, launches, per_step, errs)
    for k in kernels:
        require(all(isinstance(k[f], float) and math.isfinite(k[f])
                    for f in ("ms", "plain_ms", "bound_ms", "library_ms")),
                f"non-finite time in {k}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
