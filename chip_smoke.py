#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deepspeed_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (Hopper,
sm_90a). In order, any failure exiting non-zero:

1. device check: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles deepspeed_tpu_torch/csrc/*.cu (one nvcc per source, in
   parallel) and prints the build seconds and ptxas register counts;
3. each kernel against its plain PyTorch version on the card, in bf16, at the
   main path's shapes: max abs error against a stated tolerance, and the
   kernel's, plain version's and library call's times (CUDA events, median
   of single launches with L2 flushed before each) beside the bound;
4. a reference check: a two-layer full-width Llama-3-8B, kernel path against
   plain path, prefill and three cached decode steps;
5. the main path: init_inference(llama("llama3-8b"), bf16, kernel injection,
   max_tokens=1024) with seeded random weights at full depth, and generate on
   three requests; the launch counters, zeroed just before, must show every
   kernel ran;
6. the kernels line (one JSON object), then the device line (last line).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.decoding import forward_with_cache, init_cache
from deepspeed_tpu_torch.models.transformer import apply
from deepspeed_tpu_torch.ops import cuda as kernels
from deepspeed_tpu_torch.ops.attention import attention_impl
from deepspeed_tpu_torch.ops.cuda import _build
from deepspeed_tpu_torch.ops.cuda import decode_attention as dec
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import rmsnorm as rn
from deepspeed_tpu_torch.ops.normalization import kernel_rmsnorm_scope

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
BF16 = torch.bfloat16

KERNELS = {
    "flash_attention_fwd": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:175",
    },
    "decode_attention": {
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:76",
    },
    "rmsnorm_fwd": {
        "source": "deepspeed_tpu_torch/csrc/rmsnorm.cu",
        "replaces": "deepspeed_tpu/ops/pallas/rmsnorm.py:23",
    },
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the two least times."""
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


class Timer:
    """Median device time of single launches, L2 flushed before each."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_flash(gen, timer):
    H, KV, D = 32, 8, 128
    tol_out, tol_lse = 2e-2, 1e-3
    worst = 0.0
    for B, S in ((2, 512), (2, 160), (4, 512)):
        q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=BF16)
        k = torch.randn(B, S, KV, D, generator=gen, device="cuda", dtype=BF16)
        v = torch.randn(B, S, KV, D, generator=gen, device="cuda", dtype=BF16)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        print(f"flash_attention_fwd B={B} S={S} H={H} KV={KV} D={D}: "
              f"max_abs_err out {e_out:.3e} (tol {tol_out}) lse {e_lse:.3e} "
              f"(tol {tol_lse})")
        require(e_out <= tol_out and e_lse <= tol_lse,
                f"flash_attention_fwd disagrees at B={B} S={S}")
        worst = max(worst, e_out)
    # timed at the main path's largest prefill: B=4, prompt bucket 512
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = B * H * S * (S + 1) / 2
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * B * H * S
    b_ms, b_by = bound(4 * D * pairs, nbytes)
    return {
        "max_abs_err": worst,
        "ms": timer(lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
        "plain_ms": timer(lambda: fa.flash_attention_plain(q, k, v, causal=True)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B={B} S={S} H={H} KV={KV} D={D} causal",
    }


def check_decode(gen, timer):
    B, Smax, H, KV, D = 4, 1024, 32, 8, 128
    tol = 1e-2
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda", dtype=BF16)
    # one layer of a two-layer cache: the kernel reads the view in place
    cache_k = torch.randn(2, B, Smax, KV, D, generator=gen, device="cuda", dtype=BF16)
    cache_v = torch.randn(2, B, Smax, KV, D, generator=gen, device="cuda", dtype=BF16)
    kc, vc = cache_k[1], cache_v[1]
    frontier = torch.tensor([0, 37, 511, 1023], dtype=torch.int32, device="cuda")
    worst = 0.0
    for cl in (frontier, 700):
        out = dec.decode_attention(q, kc, vc, cl)
        ref = dec.decode_attention_plain(q, kc, vc, cl)
        e = max_err(out, ref)
        print(f"decode_attention B={B} Smax={Smax} H={H} KV={KV} D={D} "
              f"cache_len={cl.tolist() if torch.is_tensor(cl) else cl}: "
              f"max_abs_err {e:.3e} (tol {tol})")
        require(e <= tol, f"decode_attention disagrees at cache_len={cl}")
        worst = max(worst, e)
    n_keys = sum(min(int(c) + 1, Smax) for c in frontier.tolist())
    nbytes = 2 * 2 * n_keys * KV * D + 2 * 2 * B * H * D + 4 * B
    b_ms, b_by = bound(4 * H * D * n_keys, nbytes)
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(Smax, device="cuda")[None, :]
            <= frontier[:, None].long())[:, None, None, :]
    return {
        "max_abs_err": worst,
        "ms": timer(lambda: dec.decode_attention(q, kc, vc, frontier)),
        "plain_ms": timer(lambda: dec.decode_attention_plain(q, kc, vc, frontier)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B={B} Smax={Smax} H={H} KV={KV} D={D} cache_len={frontier.tolist()}",
    }


def check_rmsnorm(gen, timer):
    D, eps = 4096, 1e-5
    atol, rtol = 1e-3, 1.6e-2  # two bf16 ulps of the plain result
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(BF16)
    worst = 0.0
    for rows in (4 * 512, 4):
        x = torch.randn(rows, D, generator=gen, device="cuda", dtype=BF16)
        out = rn.rmsnorm_fwd(x, w, eps)
        ref = rn.rmsnorm_plain(x, w, eps)
        e = max_err(out, ref)
        ok = bool(((out.float() - ref.float()).abs()
                   <= atol + rtol * ref.float().abs()).all())
        print(f"rmsnorm_fwd rows={rows} D={D}: max_abs_err {e:.3e} "
              f"(tol {atol} + {rtol}*|ref|)")
        require(ok, f"rmsnorm_fwd disagrees at rows={rows}")
        worst = max(worst, e)
    x = torch.randn(4 * 512, D, generator=gen, device="cuda", dtype=BF16)
    b_ms, b_by = bound(4 * x.numel(), 2 * 2 * x.numel() + 2 * D)
    return {
        "max_abs_err": worst,
        "ms": timer(lambda: rn.rmsnorm_fwd(x, w, eps)),
        "plain_ms": timer(lambda: rn.rmsnorm_plain(x, w, eps)),
        "library_ms": timer(lambda: F.rms_norm(x, (D,), w, eps)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"rows={x.shape[0]} D={D}",
    }


def check_other_forms(gen):
    """The other shapes and dtypes the wrappers take (head_dim 64, ragged
    and short sequences, non-causal, fp32 cache and norms), each against
    its plain version on the card."""
    F32 = torch.float32

    def rand(*shape, dtype=BF16):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    cases = []
    for B, S, H, KV, D, causal in ((1, 37, 8, 2, 64, True), (3, 200, 4, 4, 128, False),
                                   (1, 1, 32, 8, 128, True)):
        q, k, v = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal)
        cases.append((f"flash B={B} S={S} H={H} KV={KV} D={D} causal={causal}",
                      max(max_err(out, ref), max_err(lse, ref_lse)), 2e-2))
    for dtype, D, H, KV, tol in ((F32, 64, 4, 2, 1e-4), (F32, 128, 32, 8, 1e-4),
                                 (BF16, 64, 8, 1, 1e-2)):
        q = rand(2, 1, H, D, dtype=dtype)
        kc, vc = rand(2, 300, KV, D, dtype=dtype), rand(2, 300, KV, D, dtype=dtype)
        for cl in (torch.tensor([299, 64], dtype=torch.int32, device="cuda"), 31):
            err = max_err(dec.decode_attention(q, kc, vc, cl),
                          dec.decode_attention_plain(q, kc, vc, cl))
            cases.append((f"decode {dtype} D={D} H={H} KV={KV} cache_len="
                          f"{cl.tolist() if torch.is_tensor(cl) else cl}", err, tol))
    for xd, wd, tol in ((F32, F32, 1e-4), (F32, BF16, 1e-4), (BF16, F32, 6.25e-2)):
        x, w = rand(5, 4096, dtype=xd), (1 + 0.1 * rand(4096, dtype=F32)).to(wd)
        err = max_err(rn.rmsnorm_fwd(x, w), rn.rmsnorm_plain(x, w))
        cases.append((f"rmsnorm x {xd} w {wd} rows=5 D=4096", err, tol))
    for name, err, tol in cases:
        print(f"{name}: max_abs_err {err:.3e} (tol {tol})")
        require(err <= tol, f"{name} disagrees with its plain version")


def reference_check():
    """Two-layer full-width Llama-3-8B in bf16: the kernel path (flash
    prefill, decode kernel, RMSNorm kernel) against the plain path on the
    same weights, prefill of 160 tokens then three cached decode steps."""
    tol = 2e-2
    model = llama("llama3-8b", num_layers=2)
    cfg = model.config
    eng = init_inference(model, dtype=BF16, replace_with_kernel_inject=True,
                         max_tokens=1024,
                         rng=torch.Generator(device="cuda").manual_seed(1))
    ids = torch.randint(0, cfg.vocab_size, (2, 163),
                        generator=torch.Generator().manual_seed(1)).cuda()

    def run():
        cache = init_cache(cfg, 2, 256, BF16, "cuda")
        logits, _ = forward_with_cache(cfg, eng.params, ids[:, :160], cache, 0)
        outs = [logits]
        for pos in range(160, 163):
            logits, _ = forward_with_cache(cfg, eng.params, ids[:, pos:pos + 1],
                                           cache, pos)
            outs.append(logits)
        return torch.cat(outs, dim=1)

    with torch.inference_mode():
        with attention_impl("auto"), kernel_rmsnorm_scope(True):
            got = run()
            fwd = apply(cfg, eng.params, ids[:, :160])
        with attention_impl("plain"), kernel_rmsnorm_scope(False):
            want = run()
    require(bool(torch.isfinite(got).all()), "non-finite logits on the kernel path")
    rel = ((got - want).norm() / want.norm()).item()
    rel_fwd = ((fwd - want[:, :160]).norm() / want[:, :160].norm()).item()
    print(f"reference check (2 layers, full width): relative L2 error "
          f"cached {rel:.3e}, no-cache forward {rel_fwd:.3e} (tol {tol})")
    require(rel <= tol and rel_fwd <= tol,
            "kernel path disagrees with the plain path")
    del eng
    torch.cuda.empty_cache()


def main_path():
    """Llama-3-8B at full width and depth, seeded random bf16 weights."""
    model = llama("llama3-8b")
    cfg = model.config
    t0 = time.perf_counter()
    engine = init_inference(model, dtype=BF16, replace_with_kernel_inject=True,
                            max_tokens=1024,
                            rng=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"main path: {cfg.name} L={cfg.num_layers} d={cfg.hidden_size} "
          f"H={cfg.num_heads} KV={cfg.kv_heads} ffn={cfg.ffn} V={cfg.vocab_size}, "
          f"depth not cut; init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    host = torch.Generator().manual_seed(0)
    V = cfg.vocab_size
    requests = [
        ("greedy B=1 P=100 new=32", torch.randint(0, V, (1, 100), generator=host),
         dict(max_new_tokens=32)),
        ("greedy B=4 P=512 new=64", torch.randint(0, V, (4, 512), generator=host),
         dict(max_new_tokens=64)),
        ("sampled B=2 P=37 new=16 T=0.8 top_k=50 top_p=0.9",
         torch.randint(0, V, (2, 37), generator=host),
         dict(max_new_tokens=16, temperature=0.8, top_k=50, top_p=0.9)),
    ]

    def serve(report: bool):
        outs = []
        for name, prompt, kw in requests:
            rng = torch.Generator(device="cuda").manual_seed(3)
            t0 = time.perf_counter()
            out = engine.generate(prompt, rng=rng, **kw)
            wall = time.perf_counter() - t0
            B, P = prompt.shape
            require(tuple(out.shape) == (B, P + kw["max_new_tokens"]),
                    f"{name}: output shape {tuple(out.shape)}")
            require(bool((out[:, :P] == prompt).all()), f"{name}: prompt not echoed")
            require(bool(((out >= 0) & (out < V)).all()),
                    f"{name}: token out of range")
            st = engine.last_generate_stats
            steps = st["decode_steps"]
            if report:
                tok_s = B * steps / (st["decode_ms"] / 1e3)
                print(f"request {name}: prefill {st['prefill_ms']:.2f} ms "
                      f"(bucket {st['prompt_bucket']}), decode {steps} steps "
                      f"{st['decode_ms']:.2f} ms = "
                      f"{st['decode_ms'] / steps:.3f} ms/step, {tok_s:.1f} "
                      f"tok/s; wall {wall:.2f} s")
            outs.append(out)
        return outs

    first = serve(report=False)  # first use of every shape and kernel
    kernels.reset_launch_counts()
    second = serve(report=True)
    counts = kernels.launch_counts()
    print(f"main path launches: {counts}")
    for name, n in counts.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    for (name, _, _), a, b in zip(requests, first, second):
        require(torch.equal(a, b), f"{name}: tokens differ between two runs")
    print("reruns (greedy, and sampled with the same seed): identical tokens")

    # cost of the per-token host sync that an eos id adds (done.all()),
    # in turns: without, with, with, without
    _, prompt, kw = requests[0]
    per_step = {-1: [], V - 1: []}
    for eos in (-1, V - 1, V - 1, -1):
        engine.generate(prompt, eos_token_id=eos, **kw)
        st = engine.last_generate_stats
        per_step[eos].append(st["decode_ms"] / st["decode_steps"])
    print(f"host sync per token (B=1): ms/step with eos "
          f"{per_step[V - 1]} vs without {per_step[-1]}")
    profile_decode(engine, prompt, kw)
    return counts


def profile_decode(engine, prompt, kw):
    """Device busy share of one B=1 generate: kernel time from torch.profiler
    over the wall time of the same request run without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    engine.generate(prompt, **kw)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(prompt, **kw)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    # device-side events only: a CPU op's device time repeats its kernels'
    kernels_run = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels_run) / 1e3
    print(f"profile B=1 generate: wall {wall_ms:.2f} ms unprofiled, device "
          f"kernels {busy_ms:.2f} ms, busy share {busy_ms / wall_ms:.3f}")
    for e in sorted(kernels_run, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing run", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _build.ptxas_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    results = {
        "flash_attention_fwd": check_flash(gen, timer),
        "decode_attention": check_decode(gen, timer),
        "rmsnorm_fwd": check_rmsnorm(gen, timer),
    }
    for name, r in results.items():
        print(f"{name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    del timer
    torch.cuda.empty_cache()

    check_other_forms(gen)
    reference_check()
    counts = main_path()

    line = {"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": counts[name],
         **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}}
        for name, r in results.items()
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
