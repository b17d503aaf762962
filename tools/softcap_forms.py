"""Forms of the tanh softcap on a CUDA card, each against float64: the
capped score ``cap * tanh(scale * s / cap)`` of raw fp32 scores ``s`` as the
flash-attention kernel's bf16 softmax takes it, in base 2 (times log2 e).

Forms (one small kernel, built here with nvcc into ``build/softcap_forms``):
  tanhf     ``cap * tanhf(scale s / cap) * log2 e``: IEEE division and libm
            (the kernel's form at every head dim but 256, and before);
  tanh_approx  ``cap log2e * tanh.approx(s * (scale / cap))``: one
            special-function op, relative error about 2^-11;
  one_minus  ``cap log2e * (1 - 2 rcp(ex2(y) + 1))``, y = 2 log2 e scale s /
            cap (ex2.approx, rcp.approx);
  ex2_rcp   ``(e - 1) rcp(e + 1) cap log2e``, e = ex2(min(y, 64)): the D = 256
            kernel's ``cap_score_ex2``.
Each form's largest absolute error of the capped score (natural units) over
|s| up to 10 cap / scale and over the scores of a Gemma-2-like layer (bf16
q, k ~ N(0, 1), D = 256, scale 1/16), and the largest shift of a causal
row's log-sum-exp that the form alone causes there (the LSE of the capped
scores in float64), beside the kernel's LSE_TOL of 2e-5.  From the
repository root, on a card:

    python3 tools/softcap_forms.py

Prints one line per (cap, form) and a JSON line last.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FORMS = ("tanhf", "tanh_approx", "one_minus", "ex2_rcp")
LOG2E = 1.4426950408889634

SOURCE = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float ex2(float x) {
  float y; asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x)); return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y; asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x)); return y;
}
__device__ __forceinline__ float tanh_approx(float x) {
  float y; asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x)); return y;
}
__global__ void forms(const float* s, float* out, int n, int form, float scale, float cap) {
  const float kLog2e = 1.4426950408889634f;
  const float kin = 2.f * kLog2e * scale / cap, kout = cap * kLog2e;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float x = s[i];
    float r;
    if (form == 0) {
      r = cap * tanhf(x * scale / cap) * kLog2e;
    } else if (form == 1) {
      r = kout * tanh_approx(x * (scale / cap));
    } else if (form == 2) {
      r = kout * (1.f - 2.f * rcp(ex2(x * kin) + 1.f));
    } else {
      const float e = ex2(fminf(x * kin, 64.f));
      r = (e - 1.f) * rcp(e + 1.f) * kout;
    }
    out[i] = r;
  }
}
extern "C" int softcap_forms(const float* s, float* out, int n, int form, float scale, float cap,
                             void* stream) {
  forms<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(s, out, n, form, scale, cap);
  return (int)cudaGetLastError();
}
"""


def load():
    from repro_torch.kernels import build
    out = ROOT / "build" / "softcap_forms"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "softcap_forms.cu", out / "libsoftcap_forms.so"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.softcap_forms.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    dll.softcap_forms.restype = ctypes.c_int
    return dll


def apply(dll, s, form, scale, cap):
    """The form on the card, in natural units as float64 (base 2 / log2 e)."""
    import torch
    from repro_torch.kernels import build
    out = torch.empty_like(s)
    code = dll.softcap_forms(s.data_ptr(), out.data_ptr(), s.numel(), FORMS.index(form),
                             scale, cap, build.stream_of(s))
    if code:
        raise RuntimeError(f"softcap_forms: CUDA error {code}")
    return out.double() / LOG2E


def causal_lse(s):
    """Row log-sum-exps of [S, S] float64 scores under the causal mask."""
    import torch
    S = s.shape[0]
    mask = torch.ones(S, S, dtype=torch.bool, device=s.device).tril()
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)


def main():
    import torch
    dll = load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(36)
    scale, S, D = 256 ** -0.5, 4096, 256
    q, k = (torch.randn(S, D, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    layer = (q.float() @ k.float().T).contiguous()      # raw fp32 scores of one head
    report = {}
    for cap in (50.0, 30.0):
        sweep = torch.linspace(-10 * cap / scale, 10 * cap / scale, 2_000_001, device=dev)
        want_sweep = cap * torch.tanh(sweep.double() * scale / cap)
        want_layer = cap * torch.tanh(layer.double() * scale / cap)
        lse_want = causal_lse(want_layer)
        for form in FORMS:
            err_sweep = float((apply(dll, sweep, form, scale, cap) - want_sweep).abs().max())
            got = apply(dll, layer, form, scale, cap)
            err_layer = float((got - want_layer).abs().max())
            lse_err = float((causal_lse(got) - lse_want).abs().max())
            report[f"{form}@{cap:g}"] = dict(sweep=err_sweep, layer=err_layer, lse=lse_err)
            print(f"cap {cap:g} {form}: max|err| of the capped score {err_sweep:.3g} over "
                  f"|s| <= 10 cap / scale, {err_layer:.3g} over a Gemma-like layer "
                  f"(S={S}, D={D}, |scaled s| <= {float(layer.abs().max()) * scale:.3g}); "
                  f"its causal row LSE shift {lse_err:.3g} (LSE_TOL 2e-5)", flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "forms": report}))


if __name__ == "__main__":
    main()
