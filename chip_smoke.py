#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device and build — the card's name and power limit, then the three
   CUDA kernels compiled with nvcc for sm_90a from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all started
   together);
2. kernels against their plain PyTorch versions on the card — the case
   grids of the JAX package's kernel tests and the serving paths' shapes,
   float32 at 2e-3 and bfloat16 at 2e-2, with every K/V line that no
   query may read (past the causal extent or kv_len, below the window)
   poisoned with NaN; then reduced float32 models served on the card
   (kernels) against the same models on the CPU (plain versions): a dense
   qwen2-1.5b through chunked prefill and a moe mixtral-8x7b through the
   batch-1 prefill, teacher-forced logits and cache at 2e-3 and greedy
   engine outputs token for token;
3. the main paths — ``repro_torch.launch.serve`` at full width, bf16,
   random weights from seeds, router warm start, 6 gpqa queries through
   ``ServingRuntime`` with ``HybridFlowPolicy``, twice: the paper's pair
   (edge qwen2-1.5b, 28 layers; cloud mistral-large-123b at published
   width, 2 layers) and the model-pair swap (edge internlm2-1.8b, 24
   layers; cloud mixtral-8x7b at published width, 2 layers, whose moe
   prefills each request alone through the flash-attention kernel). Each
   run starts with every launch count at 0. Every query must complete;
   each engine's prefill chunks, batch-1 prefills and decode ticks are
   counted as they run: every one must launch its kernel once per layer,
   every launch must fall in one of them, and the plain versions never
   run;
4. times at the serving shapes — kernel, plain version and one PyTorch
   library call (``scaled_dot_product_attention``, a yardstick only: the
   port never calls it), beside the least time the card could take.

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
FLASH_CASES = [
    # (B, Sq, Sk, H, KV, hd, causal, window, q_offset) — the grid of
    # tests/test_kernels.py (q_offset = Sk - Sq when causal) ...
    (2, 64, 64, 4, 2, 32, True, None, 0),
    (1, 128, 128, 8, 8, 64, True, None, 0),
    (2, 96, 96, 4, 1, 32, True, 32, 0),
    (1, 37, 80, 2, 2, 16, False, None, 0),
    (1, 200, 200, 2, 1, 128, True, 64, 0),
    # ... and offsets that leave lines past the last row's causal extent
    # and below the first row's window (poisoned), or rows with no key
    (1, 24, 90, 4, 2, 32, True, 16, 40),
    (2, 1, 50, 8, 2, 16, True, None, 20),
    (1, 64, 200, 12, 1, 128, True, 32, 80),
    (1, 12, 12, 4, 2, 16, True, None, -5),
]
# the serving paths' shapes: prefill chunks of 128 over up to 512 pooled
# lines, decode over 512-line slots, head dim 128. Paper pair: edge
# qwen2-1.5b (12 query heads over 2 KV heads), cloud mistral-large-123b
# (96 over 8). Swap pair: edge internlm2-1.8b (16 over 8), cloud
# mixtral-8x7b (32 over 8, window 4096), whose batch-1 prefill runs the
# flash kernel on one whole prompt
MAIN_RAGGED = {"paper edge": (2, 128, 512, 12, 2, 128, None),
               "paper cloud": (4, 128, 512, 96, 8, 128, None),
               "swap edge": (2, 128, 512, 16, 8, 128, None)}
MAIN_DECODE = {"paper edge": (2, 512, 12, 2, 128, None),
               "paper cloud": (4, 512, 96, 8, 128, None),
               "swap edge": (2, 512, 16, 8, 128, None),
               "swap cloud": (4, 512, 32, 8, 128, None)}
MAIN_FLASH = {f"swap cloud S={n}": (1, n, n, 32, 8, 128, True, 4096, 0)
              for n in (1, 37, 128, 384)}
# the shape of each kernel's row in the kernels line
KERNEL_ROW = {"ragged_prefill_attention": "paper cloud",
              "batched_decode_attention": "paper cloud",
              "flash_attention": "swap cloud S=384"}
SOURCES = {name: (f"src/repro_torch/kernels/csrc/{name}.cu", replaces)
           for name, replaces in (
               ("ragged_prefill_attention",
                "src/repro/kernels/ragged_prefill_attention.py:84"),
               ("batched_decode_attention",
                "src/repro/kernels/batched_decode_attention.py:56"),
               ("flash_attention", "src/repro/kernels/flash_attention.py:30"))}


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


def flash_inputs(torch, case, dtype, gen):
    B, Sq, Sk, H, KV, hd = case[:6]
    dev = "cuda"
    return (torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dtype),
            torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype),
            torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype))


def flash_extent(case):
    """The K lines [lo, hi) that some query row may read."""
    B, Sq, Sk, H, KV, hd, causal, window, off = case
    lo = max(0, off - window + 1) if window else 0
    hi = max(0, min(Sk, Sq - 1 + off + 1)) if causal else Sk
    return lo, hi


def poison_flash(k, v, case):
    lo, hi = flash_extent(case)
    k, v = k.clone(), v.clone()
    for t in (k, v):
        t[:, :lo] = float("nan")
        t[:, hi:] = float("nan")
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
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ragged_prefill_attention as RP
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"ragged_prefill_attention": 0.0, "batched_decode_attention": 0.0,
            "flash_attention": 0.0}
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
        for case in FLASH_CASES + list(MAIN_FLASH.values()):
            causal, window, off = case[6:]
            kw = dict(causal=causal, window=window, q_offset=off)
            q, k, v = flash_inputs(torch, case, dtype, gen)
            want = FA.flash_attention_plain(q, k, v, **kw)
            kp, vp = poison_flash(k, v, case)
            for kk, vv, tag in ((k, v, "clean"), (kp, vp, "NaN-poisoned")):
                got = FA.flash_attention(q, kk, vv, **kw)
                torch.cuda.synchronize()
                e = max_err(torch, got, want, tol,
                            f"flash {case} {dname} {tag}")
                if causal and off < 0:       # rows with no key: zeros
                    require(bool((got[:, :-off] == 0).all()),
                            f"flash {case}: keyless rows are not zeros")
                n += 1
                if case in MAIN_FLASH.values() and dname == "bfloat16":
                    errs["flash_attention"] = max(errs["flash_attention"], e)
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


def check_small_moe(torch):
    """A reduced float32 mixtral on the card (flash, decode kernels) against
    the same model on the CPU: the batch-1 prefill of a prompt past the
    64-token window (last logits, every cache line), teacher-forced
    decode, and greedy engine outputs on the legacy path."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("mixtral-8x7b").reduced()
    gpu = M.init_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    params = {"cuda": gpu, "cpu": _to(gpu, "cpu")}
    caches = {d: M.init_cache(cfg, 1, 96, dtype=torch.float32, device=d)
              for d in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(4, cfg.vocab_size, (1, 83), generator=gen)
    err = 0.0
    with torch.no_grad():
        out = {d: M.serve_prefill(params[d], cfg,
                                  {"tokens": tokens[:, :80].to(d)},
                                  caches[d])[0] for d in ("cuda", "cpu")}
        err = max(err, max_err(torch, out["cuda"].cpu(), out["cpu"], 2e-3,
                               "reduced moe prefill logits"))
        for t in range(80, 83):
            for d in ("cuda", "cpu"):
                out[d], _ = M.serve_decode(
                    params[d], cfg, tokens[:, t:t + 1].to(d),
                    torch.tensor([t], dtype=torch.int32, device=d),
                    caches[d])
            err = max(err, max_err(torch, out["cuda"].cpu(), out["cpu"],
                                   2e-3, "reduced moe decode logits"))
        for key in ("k", "v"):
            err = max(err, max_err(torch, caches["cuda"][key].cpu(),
                                   caches["cpu"][key], 2e-3,
                                   "reduced moe cache"))
    prompts = ["You are a careful assistant. Always reason step by step. "
               + t for t in ("part one", "part two", "the third part")]
    outs = {}
    for d in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params[d], batch_slots=2, max_len=96,
                            device=d)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_done()
        require(eng.stats["prefill_backend"] == "legacy-batch1",
                f"reduced moe engine prefilled through "
                f"{eng.stats['prefill_backend']}")
        outs[d] = [r.output_ids for r in reqs]
    require(outs["cuda"] == outs["cpu"],
            f"reduced moe greedy outputs differ: {outs}")
    print(f"reduced mixtral-8x7b f32, card vs CPU: logits/cache max abs err "
          f"{err:.3g}, greedy outputs identical ({outs['cuda']})")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

KERNELS = ("ragged_prefill_attention", "batched_decode_attention",
           "flash_attention")
# the engine step each kernel serves: ServingEngine method -> kernel
STEP_KERNEL = {"_prefill_launch": "ragged_prefill_attention",
               "_decode_launch": "batched_decode_attention",
               "_prefill_slot_legacy": "flash_attention"}


def run_main_path(torch, pair, argv):
    """Serve 6 queries through the launcher with every launch count at 0;
    check and return each kernel's launches and its launches per engine
    step, as measured around each step."""
    import gc
    from repro_torch.kernels import batched_decode_attention as BD
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ragged_prefill_attention as RP
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ServingEngine

    wrappers = (RP.ragged_prefill_attention, BD.batched_decode_attention,
                FA.flash_attention)
    plains = (RP.ragged_prefill_attention_plain,
              BD.batched_decode_attention_plain, FA.flash_attention_plain)

    def counts():
        return tuple(fn.launches for fn in wrappers)

    # (engine id, step method) -> the launch deltas of each of its calls
    per_call = {}

    def measured(method, step):
        def wrapper(self, *a):
            before = counts()
            out = step(self, *a)
            if method == "_prefill_slot_legacy" or out is not None:
                per_call.setdefault((id(self), method), []).append(
                    tuple(x - y for x, y in zip(counts(), before)))
            return out
        return wrapper

    args = serve.parse_args(["--queries", "6", "--benchmark", "gpqa", *argv])
    originals = {m: getattr(ServingEngine, m) for m in STEP_KERNEL}
    for m, fn in originals.items():
        setattr(ServingEngine, m, measured(m, fn))
    try:
        for fn in wrappers:
            fn.launches = 0
        for fn in plains:
            fn.calls = 0
        t0 = time.perf_counter()
        report, edge, cloud = serve.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(zip(KERNELS, counts()))
        plain = tuple(fn.calls for fn in plains)
    finally:
        for m, fn in originals.items():
            setattr(ServingEngine, m, fn)

    require(report.n == 6, f"{pair}: {report.n} of 6 queries reported")
    require(all(r.results and len(r.results) == len(r.offload)
                for r in report.results),
            f"{pair}: a query left subtasks unfinished")
    per_step = {k: {} for k in KERNELS}
    for name, eng in (("edge", edge), ("cloud", cloud)):
        L = eng.cfg.n_layers
        calls = {m: per_call.get((id(eng), m), []) for m in STEP_KERNEL}
        prefill = ("_prefill_launch" if eng.batched_prefill
                   else "_prefill_slot_legacy")
        other = ("_prefill_slot_legacy" if eng.batched_prefill
                 else "_prefill_launch")
        n_prefill = (eng.stats["prefill_calls"] if eng.batched_prefill
                     else eng.stats["requests"])
        require(len(calls[prefill]) == n_prefill > 0
                and not calls[other]
                and len(calls["_decode_launch"]) == eng.stats["steps"] > 0,
                f"{pair} {name} engine did not both prefill ({prefill}) and "
                f"decode: {eng.stats}, "
                f"{ {m: len(c) for m, c in calls.items()} } calls")
        for m in (prefill, "_decode_launch"):
            kernel = STEP_KERNEL[m]
            i = KERNELS.index(kernel)
            seen = sorted({c[i] for c in calls[m]})
            require(seen == [L] and all(x == 0 for c in calls[m]
                                        for j, x in enumerate(c) if j != i),
                    f"{pair} {name}: {kernel} launches per {m} call {seen}, "
                    f"want one per layer ({L}) and no other kernel")
            per_step[kernel][name] = {"per_call": L, "calls": len(calls[m]),
                                      "step": m.strip("_")}
    # every launch of the run happened inside one of those calls
    for i, kernel in enumerate(KERNELS):
        attributed = sum(c[i] for cs in per_call.values() for c in cs)
        require(attributed == launches[kernel],
                f"{pair}: {kernel}: {launches[kernel]} launches, "
                f"{attributed} inside engine steps")
    require(plain == (0, 0, 0),
            f"{pair}: plain versions ran on the main path: {plain}")
    tokens = edge.stats["tokens_out"] + cloud.stats["tokens_out"]
    routes = ["".join("C" if r.offload[s] else "e" for s in sorted(r.offload))
              for r in report.results]
    print(f"main path [{pair}: {edge.cfg.arch_id} + {cloud.cfg.arch_id}]: "
          f"{report.n} queries, routes {routes}, {tokens} tokens out (edge "
          f"{edge.stats['tokens_out']}, cloud {cloud.stats['tokens_out']}), "
          f"wall {wall:.2f} s; launches {launches}, per engine step as "
          f"measured {per_step}; plain-version calls {plain}")
    del report, edge, cloud
    gc.collect()
    torch.cuda.empty_cache()
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


def flash_work(case, elem):
    """Bytes and flops of one flash call: q in, out, and the K/V lines some
    row may read once; 4*hd flops per admitted (query head, key) pair."""
    B, Sq, Sk, H, KV, hd, causal, window, off = case
    lo, hi = flash_extent(case)
    pairs = 0
    for i in range(Sq):
        qpos = i + off
        r_lo = max(0, qpos - window + 1) if window else 0
        r_hi = max(0, min(Sk, qpos + 1)) if causal else Sk
        pairs += max(0, r_hi - r_lo)
    nbytes = (2 * B * Sq * H * hd + 2 * B * max(0, hi - lo) * KV * hd) * elem
    return nbytes, 4 * hd * H * B * pairs


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(torch, launches, per_step, errs):
    """Time each kernel, its plain version and SDPA at every serving shape;
    return the kernels line's rows (one per kernel, at KERNEL_ROW)."""
    import torch.nn.functional as F
    from repro_torch.kernels import batched_decode_attention as BD
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ragged_prefill_attention as RP
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    n_sets = 8                 # 8 input sets of MBs each: more than the L2
    dev = "cuda"

    def bhsd(t):               # SDPA's [B, H, S, hd] layout
        return t.transpose(1, 2).contiguous()

    timed = []                 # (kernel, shape name, row)
    for shape, case in MAIN_RAGGED.items():
        G, S, W, H, KV, hd, _ = case
        sets = [ragged_inputs(torch, case, dt, gen, full_rows=True)
                for _ in range(n_sets)]
        lib_sets = []
        for q, k, v, pos0, take in sets:
            qpos = pos0[:, None] + torch.arange(S, device=dev)
            mask = torch.arange(W, device=dev)[None, None] <= qpos[..., None]
            lib_sets.append((bhsd(q), bhsd(k), bhsd(v), mask[:, None]))
        pos0_l, take_l = sets[0][3].tolist(), sets[0][4].tolist()
        row = {"ms": time_ms(torch, lambda i: RP.ragged_prefill_attention(
                   *sets[i]), n_sets),
               "plain_ms": time_ms(torch, lambda i: RP.
                                   ragged_prefill_attention_plain(*sets[i]),
                                   n_sets, iters=5),
               "library_ms": time_ms(torch, lambda i: F.
                                     scaled_dot_product_attention(
                                         *lib_sets[i][:3],
                                         attn_mask=lib_sets[i][3],
                                         enable_gqa=True), n_sets),
               "work": ragged_work(pos0_l, take_l, S, H, KV, hd, 2),
               "shape": f"{shape} G={G} S={S} W={W} H={H} KV={KV} hd={hd} "
                        f"pos0={pos0_l} take={take_l} bf16"}
        timed.append(("ragged_prefill_attention", shape, row))
    for shape, case in MAIN_DECODE.items():
        B, M, H, KV, hd, _ = case
        kv_len = torch.tensor([(M - 1) * (b + 1) // B for b in range(B)],
                              dtype=torch.int32, device=dev)
        sets = [decode_inputs(torch, case, dt, gen, kv_len=kv_len)
                for _ in range(n_sets)]
        mask = torch.arange(M, device=dev)[None] < kv_len[:, None]
        lib_sets = [(bhsd(q), bhsd(k), bhsd(v), mask[:, None, None])
                    for q, k, v, _ in sets]
        row = {"ms": time_ms(torch, lambda i: BD.batched_decode_attention(
                   *sets[i]), n_sets),
               "plain_ms": time_ms(torch, lambda i: BD.
                                   batched_decode_attention_plain(*sets[i]),
                                   n_sets, iters=10),
               "library_ms": time_ms(torch, lambda i: F.
                                     scaled_dot_product_attention(
                                         *lib_sets[i][:3],
                                         attn_mask=lib_sets[i][3],
                                         enable_gqa=True), n_sets),
               "work": decode_work(kv_len.tolist(), H, KV, hd, 2),
               "shape": f"{shape} B={B} M={M} H={H} KV={KV} hd={hd} "
                        f"kv_len={kv_len.tolist()} bf16"}
        timed.append(("batched_decode_attention", shape, row))
    for shape in ("swap cloud S=128", "swap cloud S=384"):
        case = MAIN_FLASH[shape]
        B, Sq, Sk, H, KV, hd, causal, window, off = case
        kw = dict(causal=causal, window=window, q_offset=off)
        sets = [flash_inputs(torch, case, dt, gen) for _ in range(n_sets)]
        lib_sets = [tuple(bhsd(t) for t in s) for s in sets]
        # window 4096 > S: SDPA's causal mask is the same function
        row = {"ms": time_ms(torch, lambda i: FA.flash_attention(
                   *sets[i], **kw), n_sets),
               "plain_ms": time_ms(torch, lambda i: FA.flash_attention_plain(
                   *sets[i], **kw), n_sets, iters=10),
               "library_ms": time_ms(torch, lambda i: F.
                                     scaled_dot_product_attention(
                                         *lib_sets[i], is_causal=True,
                                         enable_gqa=True), n_sets),
               "work": flash_work(case, 2),
               "shape": f"{shape} B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} "
                        f"hd={hd} causal window={window} bf16"}
        timed.append(("flash_attention", shape, row))

    rows = []
    for kernel, shape, row in timed:
        t_bound, by = bound(*row.pop("work"))
        row.update(bound_ms=t_bound, bound_by=by)
        print(f"timing {kernel} [{row['shape']}]: kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, sdpa "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({by})")
        if KERNEL_ROW[kernel] == shape:
            source, replaces = SOURCES[kernel]
            rows.append({
                "name": kernel, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(run[kernel] for run in launches.values()),
                "launches_per_run": {p: run[kernel]
                                     for p, run in launches.items()},
                "launches_per_step": {p: run[kernel]
                                      for p, run in per_step.items()},
                "max_abs_err": errs[kernel], **row})
    return rows


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

    # phase 2: kernels against their plain versions, small models vs CPU
    errs = check_kernels(torch)
    check_small_model(torch)
    check_small_moe(torch)

    # phase 3: the main paths at full width, each from launch counts of 0
    launches, per_step = {}, {}
    for pair, argv in (("paper pair", []),
                       ("swap pair", ["--edge-arch", "internlm2-1.8b",
                                      "--cloud-arch", "mixtral-8x7b"])):
        launches[pair], per_step[pair] = run_main_path(torch, pair, argv)

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
