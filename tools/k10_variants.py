"""K10 (the band gather as a take) with each mechanism taken out, all in one
library and one process, timed in turns on the layouts of
`tools/op_times.py band_cells`, beside K9 and `index_select`:

    python tools/k10_variants.py BAND_CELLS.pt [ROUNDS]

Builds the K10 region of `unidistill_torch/csrc/band_gather.cu` as these
variants (`tools/variant_build.py`):
  shipped        the region as it is;
  row_per_piece  each piece finds its source row itself (`band_row`: the
                 w and idx loads, a division by R, the clips) instead of
                 reading the tile's table in shared memory;
  div_per_piece  each piece's (row, piece) by a 64-bit division, as the
                 parent did, instead of the thread's carried step;
  pieces1        one piece a thread (no loads in flight before stores);
  pieces8        eight pieces a thread;
  pieces16       sixteen pieces a thread;
  plain_stores   ordinary stores instead of st.global.cs.
Each variant's output lands in a block just filled with NaN
(`harness.poisoned_call`) and must equal the plain gather bit for bit.
Prints the card, the SASS instruction count of each variant's kernel,
then per layout ROUNDS (default 2) rounds of one JSON line per variant,
for K9 (`band_gather_fori`) and for `index_select` on the clipped rows:
`ms` device time from torch.profiler (`harness.device_ms`), `ms_source`,
`events_ms`.
"""
import ctypes
import json
import subprocess
import sys

import torch

import variant_build as vb

sys.path.insert(0, str(vb.ROOT))
from unidistill_torch.experiments.harness import device_ms, poisoned_call  # noqa: E402
from unidistill_torch.ops import band_gather as bg  # noqa: E402

LOAD_LINE = "      if (p0 + u * kTThreads < n) v[u] = take_load(src[r] + c);"
PIECES = "constexpr int kTPieces = 4; "
VARIANTS = {
    "shipped": [],
    "row_per_piece": [(LOAD_LINE, "      if (p0 + u * kTThreads < n)\n"
                                  "        v[u] = take_load(tab + (long long)band_row(idx, w, row0 + r, R, band, n_tab) * vpr + c);")],
    "div_per_piece": [(LOAD_LINE, "      if (p0 + u * kTThreads < n) {\n"
                                  "        const long long t = (long long)row0 * vpr + p0 + u * kTThreads;\n"
                                  "        const long long k = t / vpr;\n"
                                  "        v[u] = take_load(src[(int)(k - row0)] + (int)(t - k * vpr));\n"
                                  "      }")],
    "pieces1": [(PIECES, "constexpr int kTPieces = 1; ")],
    "pieces8": [(PIECES, "constexpr int kTPieces = 8; ")],
    "pieces16": [(PIECES, "constexpr int kTPieces = 16; ")],
    "plain_stores": [("{ __stcs(p, v); }", "{ *p = v; }")],
}
ENTRY = ("int take_{v}(const void* tab, const void* idx, const void* w, void* out, int n_tab, int S, int R,\n"
         "           int band, int vpr, void* stream) {{\n"
         "  v_{v}::take_launch(static_cast<const uint4*>(tab), static_cast<const int*>(idx),\n"
         "                     static_cast<const int*>(w), static_cast<uint4*>(out), n_tab, S, R, band, vpr,\n"
         "                     static_cast<cudaStream_t>(stream));\n"
         "  return cudaGetLastError();\n}}")
_P, _I = ctypes.c_void_p, ctypes.c_int


def main(cells_file, rounds):
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    text = vb.variants_source("band_gather", "K10", VARIANTS, ENTRY)
    lib = vb.build_library(text, "k10_variants", (_P,) * 4 + (_I,) * 5 + (_P,), VARIANTS, "take_")
    for kernel, c in vb.sass_counts(vb.ROOT / "build" / "k10_variants" / "k10_variants.so",
                                    r"band_gather_take_kernel").items():
        print(json.dumps(dict(sass=kernel, instructions=c["total"], **{k: v for k, v in c.items() if k != "total"})),
              flush=True)

    def call(name, tab, idx, w, R, band):
        out = tab.new_empty(idx.shape[0], tab.shape[1])
        err = getattr(lib, "take_" + name)(tab.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                                           tab.shape[0], idx.shape[0], R, band, tab.shape[1] * tab.element_size() // 16,
                                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed with cudaError {err}")
        return out

    for layout, (tab, idx, w, R, band) in torch.load(cells_file).items():
        tab, idx, w = tab.cuda(), idx.cuda(), w.cuda()
        ref = bg.band_gather_plain(tab, idx, w, R, band)
        src = bg.band_source_rows(idx, w, R, band).long()
        calls = {name: (lambda name=name: call(name, tab, idx, w, R, band), "band_gather_take_kernel")
                 for name in VARIANTS}
        for name, (fn, _) in calls.items():
            got = poisoned_call(fn, ref.numel() * ref.element_size())
            if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                raise RuntimeError(f"{name} on {layout}: differs from the plain gather")
            del got
        calls["K9"] = (lambda: bg.band_gather_fori(tab, idx, w, R, band), "band_gather_fori_kernel")
        calls["index_select"] = (lambda: tab.index_select(0, src), None)
        del ref
        for rnd in range(rounds):
            for name, (fn, kname) in calls.items():
                ms, source, events_ms = device_ms(fn, kname)
                print(json.dumps(dict(layout=layout, variant=name, round=rnd, ms=round(ms, 5), ms_source=source,
                                      events_ms=round(events_ms, 5))), flush=True)
        del tab, idx, w, src
        torch.cuda.empty_cache()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("k10_variants: needs a CUDA device")
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 2)
