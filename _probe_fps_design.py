#!/usr/bin/env python3
"""The measurements behind the design of K1 (``patchaugnet_tpu_torch/csrc/fps.cu``).

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 _probe_fps_design.py

Builds ``_probe_fps_design.cu`` with nvcc into ``build/probe/`` and
prints, beside the card's name and power limit:

- the latency in cycles of one step of dependent chains of the primitives
  a pick can be made of, at 32 to 1024 threads in one block, and the SM
  clock over a spin;
- a thread-block cluster's barrier and a load from another block's shared
  memory, at clusters of 1 to 8 blocks;
- K1's register kernel with the pick's coordinates read from a shared copy
  of the cloud (the port's design) against passed through the warps'
  winner slots from the winning lanes' registers, at the forward's three
  SA levels at B=32, each held bit-equal to the plain version.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
VARIANT_LAYOUTS = ((32, 4), (256, 4), (256, 16), (512, 2), (512, 8), (1024, 1), (1024, 4))
LATENCY_NAMES = ("redux.sync max", "shuffle + max", "ballot", "shared load + block barrier",
                 "shared load", "redux max then redux min (a warp arg-max)", "5-round shuffle tree")


def main():
    import torch

    if not torch.cuda.is_available():
        print("_probe_fps_design: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from profile_torch import device_ms
    from patchaugnet_tpu_torch import ops
    from patchaugnet_tpu_torch.ops import fps
    from patchaugnet_tpu_torch.ops.cuda import _build

    card = smoke.card_line()
    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libprobe_fps_design.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(ROOT, "_probe_fps_design.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.run_latency.argtypes = [p, i, i]
    lib.run_cluster.argtypes = [p, i, i, i]
    lib.run_fps_variant.argtypes = [p, p, i, i, i, i, i, i]

    iters = 1000
    out = torch.zeros(10, dtype=torch.int64, device="cuda")
    for threads in (32, 256, 512, 1024):
        for _ in range(2):   # the first run warms up
            err = lib.run_latency(out.data_ptr(), threads, iters)
        if err:
            raise RuntimeError(f"run_latency: CUDA error {err}")
        o = out.tolist()
        text = ", ".join(f"{name} {o[k] / iters:.1f}" for k, name in enumerate(LATENCY_NAMES))
        print(f"[{card}] cycles per step at {threads} threads in one block: {text}; "
              f"SM clock {o[7] / o[8] * 1e3:.0f} MHz", flush=True)
    for cluster in (1, 2, 4, 8):
        for threads in (256, 512):
            out.zero_()
            for _ in range(2):
                err = lib.run_cluster(out.data_ptr(), cluster, threads, iters)
            if err:
                raise RuntimeError(f"run_cluster: CUDA error {err}")
            o = out.tolist()
            print(f"[{card}] cluster of {cluster} blocks of {threads} threads, cycles per step: shared load + "
                  f"cluster.sync {o[0] / iters:.1f}, + relaxed cluster arrive/wait {o[3] / iters:.1f}; load from "
                  f"another block's shared memory {o[1] / iters:.1f}, from its own {o[2] / iters:.1f}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = smoke.level_clouds(torch, ops, fps._farthest_point_sample_torch, gen)

    def run(pts, m, threads, ppt, slots):
        b, n, _ = pts.shape
        idx = torch.empty((b, m), dtype=torch.int32, device=dev)
        err = lib.run_fps_variant(pts.data_ptr(), idx.data_ptr(), b, n, m, threads, ppt, slots)
        if err:
            raise RuntimeError(f"run_fps_variant: CUDA error {err}")
        return idx

    for level in range(3):
        pts, m = x[level], x[level + 1].shape[1]
        b, n, _ = pts.shape
        want = fps._farthest_point_sample_torch(pts, m)
        for threads, ppt in VARIANT_LAYOUTS:
            if threads * ppt < n or threads * ppt >= 4 * n:
                continue
            times = []
            for slots in (0, 1):
                if not torch.equal(run(pts, m, threads, ppt, slots), want):
                    raise AssertionError(f"SA{level} ({threads}, {ppt}) slots={slots}: differs from the plain version")
                times.append(device_ms(torch, lambda: run(pts, m, threads, ppt, slots), 10, "fps_variant")[0])
            print(f"[{card}] K1 SA{level} (b,n,m)=({b},{n},{m}) layout ({threads}, {ppt}): coordinates from the "
                  f"shared cloud {times[0]:.4f} ms, through the winner slots {times[1]:.4f} ms "
                  f"({times[1] / times[0] - 1:+.1%}), both bit-equal to the plain version", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
