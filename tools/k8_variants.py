"""K8 (2x + y in bf16) in variants of its launch geometry and caching, all in
one library and one process, timed in turns beside `torch.add(y, x,
alpha=2)` at [256, 256] by device time:

    python tools/k8_variants.py [ROUNDS]

First reads `torch.add`'s kernel from a torch.profiler trace (name, grid,
block, registers, values a thread). Then builds the K8 region of
`unidistill_torch/csrc/fused_offsets.cu` as these variants
(`tools/variant_build.py`):
  shipped        the region as it is;
  torch_geometry torch.add's block size and values a thread;
  threads64      64-thread blocks, a vector a thread (the earlier geometry);
  threads256     256-thread blocks;
  vecs2          two vectors a thread;
  nc_cs          loads ld.global.nc.L1::no_allocate, stores st.global.cs;
  plain_loads    loads without the read-only path (ld.global);
  checked        the instance with bound tests and the tail also where
                 the blocks cover n exactly.
Each variant must equal 2x + y rounded once, bit for bit, with its output
in a block just filled with NaN (`harness.poisoned_call`), at [256, 256],
at 2^20 + 3 values (the tail) and on views 2 bytes off the 16-byte grid.
Prints the card, each kernel's geometry from the trace, the SASS
instruction count of each variant's vector kernel, then ROUNDS (default 4)
rounds of one JSON line per variant and for torch.add: `ms` device time
from torch.profiler (`harness.device_ms`), `ms_source`, `events_ms`.
"""
import ctypes
import json
import subprocess
import sys

import torch

import variant_build as vb

sys.path.insert(0, str(vb.ROOT))
from unidistill_torch.experiments.harness import device_ms, kernel_geometry, poisoned_call  # noqa: E402
from unidistill_torch.ops import fused_offsets as fo  # noqa: E402

NC_LOAD = """__device__ __forceinline__ uint4 ax_load(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}"""
LOAD = "__device__ __forceinline__ uint4 ax_load(const uint4* p) { return __ldg(p); }"
STORE = "__device__ __forceinline__ void ax_store(uint4* p, const uint4& v) { *p = v; }"
THREADS = "constexpr int kAxThreads = 128;"
VECS = "constexpr int kAxVecs = 1;"
ENTRY = ("int axpy2_{v}(const void* x, const void* y, void* out, long long n, void* stream) {{\n"
         "  return v_{v}::axpy2_launch(x, y, out, n, static_cast<cudaStream_t>(stream));\n}}")


def variants(threads, vecs):
    return {
        "shipped": [],
        "torch_geometry": [(THREADS, f"constexpr int kAxThreads = {threads};"),
                           (VECS, f"constexpr int kAxVecs = {vecs};")],
        "threads64": [(THREADS, "constexpr int kAxThreads = 64;")],
        "threads256": [(THREADS, "constexpr int kAxThreads = 256;")],
        "vecs2": [(VECS, "constexpr int kAxVecs = 2;")],
        "nc_cs": [(LOAD, NC_LOAD),
                  (STORE, "__device__ __forceinline__ void ax_store(uint4* p, const uint4& v) { __stcs(p, v); }")],
        "plain_loads": [(LOAD, "__device__ __forceinline__ uint4 ax_load(const uint4* p) { return *p; }")],
        "checked": [("const bool whole = m % (8 * kPer) == 0;", "const bool whole = false;")],
    }


def main(rounds):
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(31)
    x = torch.randn(256, 256, generator=gen).mul(4).to(torch.bfloat16).cuda()
    y = torch.randn(256, 256, generator=gen).to(torch.bfloat16).cuda()
    add = lambda: torch.add(y, x, alpha=2)  # noqa: E731
    (tg,) = kernel_geometry(add, None)
    per_thread = x.numel() // tg["threads"]
    print(json.dumps(dict(op="torch.add", values_per_thread=per_thread, **tg)), flush=True)
    table = variants(tg["block"][0], max(1, per_thread // 8))
    text = vb.variants_source("fused_offsets", "K8", table, ENTRY)
    lib = vb.build_library(text, "k8_variants", (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_void_p),
                              table, "axpy2_")
    for kernel, c in vb.sass_counts(vb.ROOT / "build" / "k8_variants" / "k8_variants.so", r"axpy2_kernel").items():
        print(json.dumps(dict(sass=kernel, instructions=c["total"], **{k: v for k, v in c.items() if k != "total"})),
              flush=True)

    def call(name, a, b):
        out = torch.empty_like(a)
        err = getattr(lib, "axpy2_" + name)(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed with cudaError {err}")
        return out

    n = (1 << 20) + 3
    xl = torch.randn(n + 1, generator=gen).mul(4).to(torch.bfloat16).cuda()
    yl = torch.randn(n + 1, generator=gen).to(torch.bfloat16).cuda()
    for name in table:
        for a, b in ((x, y), (xl[:n], yl[:n]), (xl[1:], yl[1:])):
            got = poisoned_call(lambda: call(name, a, b), a.numel() * 2)
            if not torch.equal(got.view(torch.int16), fo.smoke_plain(a, b).view(torch.int16)):
                raise RuntimeError(f"{name}: differs from 2x + y rounded once at n={a.numel()}")
        (g,) = kernel_geometry(lambda: call(name, x, y), "axpy2_kernel")
        print(json.dumps(dict(variant=name, values_per_thread=x.numel() // g["threads"], **g)), flush=True)
    calls = {name: (lambda name=name: call(name, x, y), "axpy2_kernel") for name in table}
    calls["torch.add"] = (add, None)
    for rnd in range(rounds):
        for name, (fn, kname) in calls.items():
            ms, source, events_ms = device_ms(fn, kname)
            print(json.dumps(dict(variant=name, round=rnd, ms=round(ms, 7), ms_source=source,
                                  events_ms=round(events_ms, 5))), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("k8_variants: needs a CUDA device")
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
