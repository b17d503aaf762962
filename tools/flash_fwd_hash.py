"""Kernel 6 (the flash-attention forward, ``csrc/flash_attention.cu``) of
several source trees on one CUDA card: the same seeded inputs through each
tree's kernel, a SHA-256 of every output (and row LSE) and the kernel's
time, so that a change to the kernel can be shown to leave a shape's
output bitwise as it was.  Cases: Granite-34B-code's prefill layer (B=1,
S=32,768, 48:1 heads of 128, bf16, causal), one train_4k micro-batch's
layer with its LSE (S=4,096), Llama-3.2-3B's prefill layer (24:8 heads),
the fp32 kernel at a windowed and a softcapped case, and every other head
dim (16, 32, 64 and 128) in both dtypes with windows, softcaps and the
row LSE; at head dim 256 (Gemma-2-2B's 8:4 heads) the bf16 kernel without
the softcap, global and windowed, with and without the LSE, the fp32
kernel with it, and Gemma's two prefill layers at S=32,768 with its
softcap of 50 and without (their times the kernel's at the model's
shapes).  The bf16 cases at D = 256 with a softcap (``SOFTCAP_256``)
are not held bitwise across trees whose softcap arithmetic differs: each
run saves their outputs, and each line gives the largest |difference| of
every run's from the first run's (0 between runs of one tree).  Each tree
runs in a process of its own (it imports that tree's ``src``); the trees
are run in the order given, so ``--trees A B B A`` interleaves them.  From
the repository root:

    python3 tools/flash_fwd_hash.py --trees build/parent . . build/parent

Prints one JSON line per run ({"tree", "hashes", "ms"}), then one line per
case naming whether every tree's output is bitwise the first's (for
``SOFTCAP_256``, the largest |difference| instead), and ``ALL EQUAL`` or
``DIFFERENT`` last, over every case outside ``SOFTCAP_256``; exits 1 when
the trees differ there.
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
    # head dim 256: the bf16 kernel without the softcap, global and windowed,
    # with and without the LSE; the fp32 kernel with a softcap
    "bf16_d256_global": (1, 8192, 8, 4, 256, True, 0, None, "bfloat16", False),
    "bf16_d256_global_lse": (2, 3000, 8, 4, 256, True, 0, None, "bfloat16", True),
    "bf16_d256_window": (1, 8192, 8, 4, 256, True, 4096, None, "bfloat16", False),
    "bf16_d256_window_lse": (1, 5000, 8, 4, 256, True, 700, None, "bfloat16", True),
    "fp32_d256_window_softcap": (1, 300, 4, 2, 256, True, 100, 50.0, "float32", True),
    # the bf16 kernel at head dim 256 with Gemma-2's softcaps
    "bf16_d256_softcap": (1, 8192, 8, 4, 256, True, 0, 50.0, "bfloat16", True),
    "bf16_d256_window_softcap": (1, 8192, 8, 4, 256, True, 4096, 30.0, "bfloat16", False),
    # Gemma-2-2B's prefill layers (chip_smoke.py's GEMMA_GLOBAL / GEMMA_LOCAL),
    # with its attention softcap of 50 and without
    "gemma_global": (1, 32768, 8, 4, 256, True, 0, None, "bfloat16", False),
    "gemma_local": (1, 32768, 8, 4, 256, True, 4096, None, "bfloat16", False),
    "gemma_global_softcap": (1, 32768, 8, 4, 256, True, 0, 50.0, "bfloat16", False),
    "gemma_local_softcap": (1, 32768, 8, 4, 256, True, 4096, 50.0, "bfloat16", False),
}
# outputs compared by their largest |difference| in place of a hash
SOFTCAP_256 = ("bf16_d256_softcap", "bf16_d256_window_softcap", "gemma_global_softcap",
               "gemma_local_softcap")
OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "flash_fwd_hash"


def run_tree(run):
    """In a child process whose ``sys.path`` starts with a tree's ``src``:
    every case through that tree's kernel; the outputs of ``SOFTCAP_256``
    saved as ``OUT_DIR / f"{run}_{name}.pt"``."""
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
        if name in SOFTCAP_256:
            OUT_DIR.mkdir(parents=True, exist_ok=True)
            torch.save([t.cpu() for t in outs], OUT_DIR / f"{run}_{name}.pt")
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
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, str(Path(args.child).resolve() / "src"))
        hashes, ms = run_tree(args.run)
        print(json.dumps({"tree": args.child, "hashes": hashes, "ms": ms}))
        return 0
    runs = []
    for i, tree in enumerate(args.trees):
        res = subprocess.run([sys.executable, __file__, "--child", tree, "--run", str(i)],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stderr[-3000:], file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    import torch
    equal = True
    for name in CASES:
        ms = "; ms by run " + ", ".join(str(r["ms"][name]) for r in runs)
        if name in SOFTCAP_256:
            first = torch.load(OUT_DIR / f"0_{name}.pt")
            diffs = []
            for i in range(len(runs)):
                outs = torch.load(OUT_DIR / f"{i}_{name}.pt")
                diffs.append(max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(outs, first)))
            print(f"{name}: max|diff| from the first run's output (and LSE) by run "
                  + ", ".join(f"{d:.3g}" for d in diffs) + ms)
            continue
        same = all(r["hashes"][name] == runs[0]["hashes"][name] for r in runs)
        equal = equal and same
        print(f"{name}: every tree bitwise the first: {same}" + ms)
    print("ALL EQUAL" if equal else "DIFFERENT")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
