"""Kernel 6 (the flash-attention forward, ``csrc/flash_attention.cu``) of
several source trees on one CUDA card: the same seeded inputs through each
tree's kernel, a SHA-256 of every output (and row LSE) and the kernel's
time, so that a change to the kernel can be shown to leave a shape's
output bitwise as it was.  Cases: Granite-34B-code's prefill layer (B=1,
S=32,768, 48:1 heads of 128, bf16, causal), one train_4k micro-batch's
layer with its LSE (S=4,096), Llama-3.2-3B's prefill layer (24:8 heads),
the fp32 kernel at a windowed and a softcapped case, and every other head
dim (16, 32, 64 and 128) in both dtypes with windows, softcaps and the
row LSE.  Each tree runs in
a process of its own (it imports that tree's ``src``); the trees are run in
the order given, so ``--trees A B B A`` interleaves them.  From the
repository root:

    python3 tools/flash_fwd_hash.py --trees build/parent . . build/parent

Prints one JSON line per run ({"tree", "hashes", "ms"}), then one line per
case naming whether every tree's output is bitwise the first's, and
``ALL EQUAL`` or ``DIFFERENT`` last; exits 1 when the trees differ.
"""
import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

# name: (B, S, Hq, Hkv, D, causal, window, softcap, dtype, with_lse)
CASES = {
    "granite_prefill": (1, 32768, 48, 1, 128, True, 0, None, "bfloat16", False),
    "granite_train_lse": (1, 4096, 48, 1, 128, True, 0, None, "bfloat16", True),
    "llama_prefill": (1, 32768, 24, 8, 128, True, 0, None, "bfloat16", False),
    "fp32_window": (1, 300, 4, 1, 64, True, 130, None, "float32", True),
    "fp32_softcap": (1, 257, 6, 2, 128, False, 0, 30.0, "float32", False),
    # every other head dim the kernels take beside 256, in both dtypes,
    # windowed, softcapped and with the row LSE
    "bf16_d16_window": (2, 1000, 4, 2, 16, True, 300, None, "bfloat16", True),
    "bf16_d32_softcap": (1, 777, 6, 3, 32, True, 0, 50.0, "bfloat16", False),
    "bf16_d64_window_softcap": (1, 1500, 8, 4, 64, True, 400, 30.0, "bfloat16", True),
    "bf16_d128_window_softcap": (1, 2000, 8, 2, 128, True, 500, 50.0, "bfloat16", True),
    "fp32_d16": (2, 300, 4, 4, 16, True, 0, None, "float32", True),
    "fp32_d32_window": (1, 400, 4, 2, 32, True, 90, 50.0, "float32", True),
}


def run_tree():
    """In a child process whose ``sys.path`` starts with a tree's ``src``:
    every case through that tree's kernel."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa

    dev = torch.device("cuda")
    hashes, ms = {}, {}
    for name, (B, S, Hq, Hkv, D, causal, window, cap, dt, with_lse) in CASES.items():
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(S + Hq)
        q = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        out = fa._launch(q, k, v, D ** -0.5, causal, window, cap, with_lse=with_lse)
        torch.cuda.synchronize()
        outs = out if with_lse else (out,)
        digest = hashlib.sha256()
        for t in outs:
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        hashes[name] = digest.hexdigest()[:16]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(2):
            fa._launch(q, k, v, D ** -0.5, causal, window, cap, with_lse=with_lse)
        start.record()
        for _ in range(5):
            fa._launch(q, k, v, D ** -0.5, causal, window, cap, with_lse=with_lse)
        end.record()
        end.synchronize()
        ms[name] = round(start.elapsed_time(end) / 5, 4)
        del q, k, v, out, outs
    return hashes, ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, str(Path(args.child).resolve() / "src"))
        hashes, ms = run_tree()
        print(json.dumps({"tree": args.child, "hashes": hashes, "ms": ms}))
        return 0
    runs = []
    for tree in args.trees:
        res = subprocess.run([sys.executable, __file__, "--child", tree],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stderr[-3000:], file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    equal = True
    for name in CASES:
        same = all(r["hashes"][name] == runs[0]["hashes"][name] for r in runs)
        equal = equal and same
        print(f"{name}: every tree bitwise the first: {same}; ms by run "
              + ", ".join(str(r["ms"][name]) for r in runs))
    print("ALL EQUAL" if equal else "DIFFERENT")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
