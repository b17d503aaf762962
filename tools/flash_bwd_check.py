"""Kernel 6 with its row log-sum-exp and kernel 6b (the flash-attention
backward, ``csrc/flash_attention_bwd.cu``) on one CUDA card, alone: builds
both sources (printing ptxas' registers), then at each case of ``CASES``,
in fp32 and bf16, holds the forward's output with the LSE bitwise to the
output without it, the LSE to ``attention_plain``'s (within 2e-5), and
the backward on the kernel's output and LSE to ``attention_plain_bwd`` on
the plain forward's (fp32 within rtol / atol 2e-5; bf16 within 1e-2 x
max(1, max |plain|) per gradient), two calls bitwise; at Granite's
training layer (B=1, S=4,096, 48:1, D=128, bf16) it also times the
backward (CUDA events, mean of 10 calls) and each of its four kernels
(torch.profiler, mean of 5 calls).  From the repository root:

    python3 tools/flash_bwd_check.py

Prints one line per case and ``ALL OK`` or ``SOME FAILED`` last; exits 1
on a failure.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# B, S, Hq, Hkv, D, causal, window
CASES = [(1, 128, 2, 2, 64, True, 0), (2, 96, 4, 2, 32, True, 0), (1, 160, 2, 1, 64, True, 48),
         (1, 64, 2, 2, 128, False, 0), (1, 72, 1, 1, 16, True, 0), (1, 1, 2, 1, 64, True, 0),
         (1, 127, 3, 1, 128, True, 0), (1, 129, 4, 4, 16, True, 0), (1, 257, 48, 1, 128, True, 0),
         (1, 300, 4, 1, 64, True, 130), (1, 257, 2, 2, 32, False, 0),
         # around the 64-row stages and 128-key / 128-row blocks, every head dim;
         # a window ending inside a tile; 9 heads in 5 groups (2, 2, 2, 2, 1)
         (1, 63, 2, 1, 16, True, 0), (1, 65, 2, 2, 32, True, 0), (1, 191, 3, 1, 64, True, 0),
         (1, 255, 2, 2, 128, True, 0), (1, 256, 4, 1, 128, False, 0), (1, 384, 7, 1, 64, True, 0),
         (2, 320, 6, 3, 128, True, 100), (1, 2048, 9, 1, 64, False, 0)]
GRANITE_TRAIN_LAYER = (1, 4096, 48, 1, 128, True, 0)


def main():
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_plain, attention_plain_bwd

    if not torch.cuda.is_available():
        print("flash_bwd_check: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    reports = build.build(["flash_attention", "flash_attention_bwd"])
    print("build s", time.perf_counter() - t0)
    for name, log in reports.items():
        for ln in log.splitlines():
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln:
                print(name, ln.strip()[:200])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    ok_all = True
    for dt in (torch.float32, torch.bfloat16):
        for case in CASES + ([GRANITE_TRAIN_LAYER] if dt == torch.bfloat16 else []):
            B, S, Hq, Hkv, D, causal, window = case
            gen = torch.Generator(device=dev).manual_seed(S + Hq)
            q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).to(dt)
                       for h in (Hq, Hkv, Hkv))
            kw = dict(scale=D ** -0.5, causal=causal, window=window)
            out0 = fa.flash_attention(q, k, v, **kw)
            out, lse = fa._launch(q, k, v, D ** -0.5, causal, window, None, with_lse=True)
            out_p, lse_p = attention_plain(q, k, v, return_lse=True, chunk=512, **kw)
            same_out = torch.equal(out0, out)
            lse_err = float((lse - lse_p).abs().max())
            g = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(dt)
            build.reset_launch_counts()
            got = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
            again = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
            torch.cuda.synchronize()
            n = build.launch_counts.get(fa.KERNEL_BWD, 0)
            want = attention_plain_bwd(q, k, v, out_p, lse_p, g, chunk=512, **kw)
            errs, oks = [], []
            for a, b in zip(got, want):
                a, b = a.float(), b.float()
                e = float((a - b).abs().max())
                if dt == torch.float32:
                    oks.append(bool(((a - b).abs() <= 2e-5 + 2e-5 * b.abs()).all()))
                else:
                    oks.append(e <= 1e-2 * max(1.0, float(b.abs().max())))
                errs.append(e)
            bit = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = all(oks) and bit and same_out and lse_err <= 2e-5
            ok_all &= ok
            msg = (f"{dt} {case}: lse err {lse_err:.3g}, out bitwise {same_out} | dq/dk/dv "
                   f"err {errs} ok {oks}, bitwise {bit}, launches {n}")
            if case == GRANITE_TRAIN_LAYER:
                def kernel():
                    return fa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
                for _ in range(2):
                    kernel()
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                for _ in range(10):
                    kernel()
                e1.record()
                e1.synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    for _ in range(5):
                        kernel()
                    torch.cuda.synchronize()
                parts = sorted(((getattr(e, "device_time_total", 0.0)
                                 or getattr(e, "cuda_time_total", 0.0)) / 5e3, e.key)
                               for e in prof.key_averages() if "flash_bwd" in e.key)
                msg += (f" | backward {e0.elapsed_time(e1) / 10:.3f} ms, "
                        f"{fa.bwd_groups(B, S, Hq, Hkv, 132)} head groups; per kernel "
                        + ", ".join(f"{k[:40]} {t:.3f} ms" for t, k in parts))
            print(msg, flush=True)
    print("ALL OK" if ok_all else "SOME FAILED")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
