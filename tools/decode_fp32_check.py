"""The port's fp32 decode attention (``models/transformer/attention.py::
decode_attention``) on a CUDA card, repeated, against a float64 product of
the same operands, to see which side of ``tests/test_torch_gpu.py::
test_decode_attention_on_card_matches_cpu`` moves when the card and the CPU
disagree.  The inputs are the test's (B=3, a 320-slot cache filled to 300,
8 query heads over 2 KV heads of 128, or 48 over 1; seeded on the CPU).

Each repeat moves the CPU tensors to the card afresh, as the test does,
runs ``decode_attention`` there, and also the same steps one by one (the
scores of each KV head, then the PV product), so that a bad repeat names
the product that moved: every result is held to float64 by its relative
L2 error per row (per query head), and the card's outputs are hashed to
count how many distinct results the repeats gave.  ``--variant`` changes
one thing around the products (a stream sync after the cache write,
contiguous copies of the cache slices, TF32 on) to test a suspect.
``--first`` runs only the test's first products in each of ``--procs``
fresh processes (the CPU's, then the card's); ``--cpu-first`` only the
CPU's, without the card, under the variants ``none``, ``threads1``,
``warm``, ``f64`` and ``ewise``.  From
the repository root, on a card:

    python3 tools/decode_fp32_check.py --repeats 300
    python3 tools/decode_fp32_check.py --procs 6 --repeats 50

Prints the math settings the products ran under, one line per variant
(worst row per side, the distinct outputs, the bad repeats and where each
moved), and a JSON line last; exits 1 when a repeat leaves the band.
"""
import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

BAND = 1e-5  # the test's fp32 band of relative L2 error per row
HEADS = {"gqa": (8, 2), "mqa": (48, 1)}
B, CAP, N, D = 3, 320, 300, 128


def inputs(heads):
    """The test's CPU inputs: q [B, Hq, D], caches [B, CAP, Hkv, D], the
    new K/V [B, Hkv, D], fp32."""
    import torch
    Hq, Hkv = HEADS[heads]
    gen = torch.Generator().manual_seed(Hq)
    q = torch.randn(B, Hq, D, generator=gen)
    kc, vc = (torch.randn(B, CAP, Hkv, D, generator=gen) for _ in range(2))
    kn, vn = (torch.randn(B, Hkv, D, generator=gen) for _ in range(2))
    return q, kc, vc, kn, vn


def float64_decode(q, kc, vc, kn, vn):
    """The decode in float64 on the CPU: (out [B, Hq, D], scores [B, Hkv,
    G, N + 1], the weighted values before the division [B, Hkv, G, D])."""
    import torch
    Hkv = kc.shape[2]
    G = q.shape[1] // Hkv
    k, v = kc.double().clone(), vc.double().clone()
    k[:, N], v[:, N] = kn.double(), vn.double()
    k, v = k[:, :N + 1].permute(0, 2, 1, 3), v[:, :N + 1].permute(0, 2, 1, 3)
    s = q.double().reshape(B, Hkv, G, D) @ k.transpose(-1, -2) * D ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = p @ v
    return (o / p.sum(-1, keepdim=True)).reshape(B, -1, D), s, o


def host():
    """What of the machine could move either side: the CPU model, torch's
    CPU capability and threads, the card's SM count and UUID."""
    import torch
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), "")
    except OSError:
        pass
    props = torch.cuda.get_device_properties(0)
    return dict(cpu=model, capability=torch.backends.cpu.get_cpu_capability(),
                threads=torch.get_num_threads(), sms=props.multi_processor_count,
                uuid=str(getattr(props, "uuid", "")))


def rel_rows(got, want):
    """Relative L2 error of each row (last dim), as float64."""
    got, want = got.double().cpu(), want.double().cpu()
    return (got - want).norm(dim=-1) / want.norm(dim=-1)


def steps_on(q, kc, vc, kn, vn, dev, variant):
    """``decode_attention``'s steps one by one on ``dev`` (the cache write,
    then per KV head the scores and the PV product), under ``variant``:
    (scores [B, Hkv, G, N + 1], weighted values [B, Hkv, G, D])."""
    import torch
    from repro_torch.models.transformer.attention import _bmm_f32
    Hkv = kc.shape[2]
    G = q.shape[1] // Hkv
    kcd, vcd = kc.to(dev), vc.to(dev)
    kcd[:, N], vcd[:, N] = kn.to(dev), vn.to(dev)
    if variant == "sync" and dev.type == "cuda":
        torch.cuda.synchronize()
    qg = q.to(dev).reshape(B, Hkv, G, D)
    ss, os_ = [], []
    for h in range(Hkv):
        kh, vh = kcd[:, :N + 1, h], vcd[:, :N + 1, h]
        if variant == "contig":
            kh, vh = kh.contiguous(), vh.contiguous()
        if variant == "f64":        # the products in float64, rounded to fp32
            s = torch.bmm(qg[:, h].double(), kh.transpose(1, 2).double()).float()
        elif variant == "ewise":    # products as a multiply and a sum, no BLAS
            s = (qg[:, h, :, None, :] * kh[:, None]).sum(-1)
        else:
            s = _bmm_f32(qg[:, h], kh.transpose(1, 2))
        s = s.mul_(D ** -0.5)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        ss.append(s)
        if variant == "f64":
            os_.append(torch.bmm(p.double(), vh.double()).float())
        elif variant == "ewise":
            os_.append((p[..., None] * vh[:, None]).sum(-2))
        else:
            os_.append(_bmm_f32(p, vh))
    return torch.stack(ss, 1), torch.stack(os_, 1)


def run(heads, repeats, variants):
    import torch
    from repro_torch.models.transformer import attention as lm_attention
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, kc, vc, kn, vn = inputs(heads)
    ref, s64, o64 = float64_decode(q, kc, vc, kn, vn)
    cpu = lm_attention.decode_attention(q, kc.clone(), vc.clone(), kn, vn, N, scale=D ** -0.5)
    cpu_rel = float(rel_rows(cpu, ref).max())
    settings = dict(allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                    precision=torch.get_float32_matmul_precision(),
                    fp32_precision=str(getattr(torch.backends.cuda.matmul, "fp32_precision",
                                               "n/a")),
                    blas=str(torch.backends.cuda.preferred_blas_library()),
                    torch=torch.__version__, cuda=torch.version.cuda,
                    card=torch.cuda.get_device_name(0), host=host())
    print(f"{heads}: settings {settings}; CPU vs float64: worst row {cpu_rel:.3g}", flush=True)
    results = {}
    for variant in variants:
        if variant == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        hashes, bad = set(), []
        worst = dict(card=0.0, card_vs_cpu=0.0, scores=0.0, pv=0.0)
        for r in range(repeats):
            kcd, vcd = kc.to(dev), vc.to(dev)
            got = lm_attention.decode_attention(q.to(dev), kcd, vcd, kn.to(dev), vn.to(dev), N,
                                                scale=D ** -0.5)
            s, o = steps_on(q, kc, vc, kn, vn, dev, variant)
            torch.cuda.synchronize()
            card = rel_rows(got, ref)
            vs_cpu = rel_rows(got, cpu)
            # the scores held by their absolute error (they cross zero), the
            # weighted values by rows
            s_err = float((s.double().cpu() - s64).abs().max())
            o_err = float(rel_rows(o, o64).max())
            hashes.add(hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:12])
            for key, val in (("card", float(card.max())), ("card_vs_cpu", float(vs_cpu.max())),
                             ("scores", s_err), ("pv", o_err)):
                worst[key] = max(worst[key], val)
            if float(vs_cpu.max()) > BAND or float(card.max()) > BAND:
                rows = [(int(b), int(h), float(card[b, h]))
                        for b, h in zip(*torch.nonzero(card > BAND, as_tuple=True))]
                bad.append(dict(repeat=r, rows_vs_float64=rows, steps_scores_abs=s_err,
                                steps_pv_rel=o_err,
                                cache_written=bool(torch.equal(kcd[:, N].cpu(), kn))))
        torch.backends.cuda.matmul.allow_tf32 = False
        results[variant] = dict(worst=worst, distinct=len(hashes), bad=len(bad))
        print(f"{heads} variant {variant}: {repeats} repeats, worst row vs float64 "
              f"{worst['card']:.3g} (card) / {cpu_rel:.3g} (CPU), card vs CPU "
              f"{worst['card_vs_cpu']:.3g}; steps alone: scores max|err| {worst['scores']:.3g}, "
              f"PV rows {worst['pv']:.3g}; distinct outputs {len(hashes)}; repeats out of the "
              f"band {len(bad)}" + (f"; first bad: {bad[:1]}" if bad else ""), flush=True)
    return dict(settings=settings, cpu_vs_float64=cpu_rel, variants=results)


def first_calls(heads):
    """The test's order in a fresh process: the CPU decode, then the card's
    (as its steps, so the scores and the PV product are seen apart), then
    the card's and the CPU's decode once more; each against float64."""
    import torch
    from repro_torch.models.transformer import attention as lm_attention
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, kc, vc, kn, vn = inputs(heads)

    def cpu():
        return lm_attention.decode_attention(q, kc.clone(), vc.clone(), kn, vn, N,
                                             scale=D ** -0.5)

    cpu1 = cpu()
    s, o = steps_on(q, kc, vc, kn, vn, dev, "none")        # the process's first products
    card = lm_attention.decode_attention(q.to(dev), kc.to(dev), vc.to(dev), kn.to(dev),
                                         vn.to(dev), N, scale=D ** -0.5).cpu()
    cpu2 = cpu()
    ref, s64, o64 = float64_decode(q, kc, vc, kn, vn)
    first_pv = rel_rows(o, o64)
    return dict(host=host()["uuid"], cpu_first=float(rel_rows(cpu1, ref).max()),
                cpu_again=float(rel_rows(cpu2, ref).max()),
                cpu_bitwise=bool(torch.equal(cpu1, cpu2)),
                first_scores_abs=float((s.double().cpu() - s64).abs().max()),
                first_pv=float(first_pv.max()),
                first_pv_rows=[(int(b), int(h), int(g)) for b, h, g in
                               torch.nonzero(first_pv > BAND).tolist()],
                card_again=float(rel_rows(card, ref).max()))


def cpu_first(variant):
    """The first fp32 products of a fresh CPU-only process, as the decode
    takes them (``steps_on`` on the CPU), against float64: the scores'
    largest absolute error and the PV product's worst row, then the same
    once more.  ``variant``: "none"; "threads1" (one CPU thread);
    "warm" (one fp32 bmm of another shape first); "f64" (the products in
    float64); "ewise" (the products as a multiply and a sum, no BLAS)."""
    import torch
    if variant == "threads1":
        torch.set_num_threads(1)
    q, kc, vc, kn, vn = inputs("gqa")
    if variant == "warm":
        torch.bmm(torch.ones(2, 3, 5), torch.ones(2, 5, 7))
    dev = torch.device("cpu")
    steps = variant if variant in ("f64", "ewise") else "none"
    s1, o1 = steps_on(q, kc, vc, kn, vn, dev, steps)
    s2, o2 = steps_on(q, kc, vc, kn, vn, dev, steps)
    _, s64, o64 = float64_decode(q, kc, vc, kn, vn)
    pv = rel_rows(o1, o64)
    return dict(variant=variant, threads=torch.get_num_threads(),
                first_scores_abs=float((s1.double() - s64).abs().max()),
                first_pv=float(pv.max()),
                first_pv_rows=torch.nonzero(pv > BAND).tolist(),
                again_scores_abs=float((s2.double() - s64).abs().max()),
                again_pv=float(rel_rows(o2, o64).max()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=200)
    ap.add_argument("--heads", nargs="+", default=["gqa", "mqa"], choices=sorted(HEADS))
    ap.add_argument("--variant", nargs="+", default=["none"],
                    choices=["none", "sync", "contig", "tf32", "threads1", "warm", "f64",
                             "ewise"])
    ap.add_argument("--procs", type=int, default=0,
                    help="run the check in this many fresh processes, one after another")
    ap.add_argument("--first", action="store_true",
                    help="only the first products of a process, in the test's order")
    ap.add_argument("--cpu-first", action="store_true",
                    help="only the first CPU products of a process (no card)")
    args = ap.parse_args()
    if args.cpu_first and not args.procs:
        print(json.dumps(cpu_first(args.variant[0])))
        return 0
    if args.cpu_first:
        for variant in args.variant:
            runs = []
            for _ in range(args.procs):
                res = subprocess.run([sys.executable, __file__, "--cpu-first", "--variant",
                                      variant], capture_output=True, text=True)
                runs.append(json.loads(res.stdout.strip().splitlines()[-1])
                            if res.returncode == 0 else {"error": res.stderr[-500:]})
            moved = [r for r in runs if "error" in r or r["first_pv"] > BAND
                     or r["first_scores_abs"] > 1e-4]
            print(f"cpu-first {variant}: {len(moved)} of {len(runs)} processes moved in their "
                  f"first products; " + "; ".join(json.dumps(r) for r in moved[:3]), flush=True)
        return 0
    if args.first and not args.procs:
        print(json.dumps(first_calls(args.heads[0])))
        return 0
    if args.first:
        runs = []
        for _ in range(args.procs):
            res = subprocess.run([sys.executable, __file__, "--first", "--heads", args.heads[0]],
                                 capture_output=True, text=True)
            line = res.stdout.strip().splitlines()[-1] if res.returncode == 0 else "{}"
            runs.append(json.loads(line))
            print(line if res.returncode == 0 else res.stderr[-2000:], flush=True)
        moved = [r for r in runs if r.get("first_pv", 0) > BAND or r.get("cpu_first", 0) > BAND
                 or r.get("first_scores_abs", 0) > 1e-4]
        print(f"{len(moved)} of {len(runs)} processes moved in their first products: "
              + "; ".join(json.dumps(r) for r in moved))
        return 1 if moved else 0
    if args.procs:
        bad = 0
        for i in range(args.procs):
            cmd = [sys.executable, __file__, "--repeats", str(args.repeats), "--heads",
                   *args.heads, "--variant", *args.variant]
            res = subprocess.run(cmd, capture_output=True, text=True)
            print(f"process {i}: rc {res.returncode}", flush=True)
            print(res.stdout.strip() or res.stderr[-2000:], flush=True)
            bad += res.returncode != 0
        print(json.dumps({"procs": args.procs, "procs_out_of_band": bad}))
        return 1 if bad else 0
    out = {h: run(h, args.repeats, args.variant) for h in args.heads}
    print(json.dumps(out))
    bad = any(v["bad"] for r in out.values() for name, v in r["variants"].items()
              if name != "tf32")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
