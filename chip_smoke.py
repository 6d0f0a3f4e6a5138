#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``patchaugnet_tpu_torch``).

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel from ``patchaugnet_tpu_torch/csrc``
   with nvcc (sm_90a) into ``build/``, one nvcc per source, all at once,
   and print the ptxas register/spill report;
2. kernels: at the shapes of the forward at B=32 (the three SA levels of
   FPS and kNN, the three FP levels of top-3 extraction) and of the
   auction EMD at (4, 4096) (the price-fused top-2 on the full
   (4, 4096, 4096) base and on the (4, 256, 4096) active-set tail, the
   two-level top-2 of a 8192-wide row chunk), hold each kernel against
   its plain torch version on the card (indices exactly equal, values
   within 1e-6, K3-K6 exactly), plus an all-equal cloud and tied
   matrices, and time kernel, plain version and a PyTorch yardstick;
3. serving: the full-width PatchAugNet (``configs.PATCH_AUG_NET``, seeded
   random weights) answers 4 requests of 32 clouds of 4096 points through
   ``serving.build_forward_fn``; every kernel's launch count must show it
   ran, the descriptors must be finite and unit-norm, and the same model
   run through the plain versions on the card must give the same
   provenance indices and descriptors within 1e-5; then descriptors/s at
   B=32 and B=100 and the peak device memory;
4. EMD: ``losses.emd_loss`` forward and backward on two (4, 4096, 3)
   clouds at the reference eps=0.02, iters=1024; K6 must have launched
   once per auction iteration plus once for the force-assign pass, the
   loss and gradient must be finite, and the assignment must equal the
   plain-kernel run on the card; then the opt-in ``unass_floor`` and
   ``eps_schedule`` modes beside it, and a short row-chunked auction at
   (1, 8192) that runs K4 (``profile_torch.py --emd`` breaks the exact
   call down by device kernel);
5. report: one ``{"kernels": [...]}`` line, the card's name and power
   limit as nvidia-smi gives them, and a last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA device or without
the rest of the repository. Imports nothing of JAX.
"""
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 32
N_POINTS = 4096
REQUESTS = 4
THROUGHPUT_BATCHES = ((32, 10), (100, 4))   # (batch size, timed batches)
PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM device memory (data sheet)
PEAK_F32_OPS_PER_S = 67e12                 # H100 SXM f32 outside the tensor cores
CARD = "unknown card"
DESCRIPTOR_KERNELS = ("fps", "knn", "topk_extract")   # K1-K3, 3 launches per forward
EMD_B, EMD_N, EMD_EPS, EMD_ITERS = 4, 4096, 0.02, 1024  # losses/pointnetvlad_loss.py:205-221
EMD_TAIL_ROWS = 256                                     # the active-set width R at n=4096
CHUNKED_N, CHUNKED_ITERS = 8192, 20                     # a row-chunked auction, K4 on its path


def say(*parts):
    print(*parts, flush=True)


def measured(label, text):
    """A line with a number, tagged with the card it was measured on."""
    say(f"[{CARD}] {label}: {text}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps, warmup=1):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, nops):
    """(least time in ms, what bounds it) on the card's published peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class KernelRecord:
    def __init__(self, name, module, source, replaces, counter="launches"):
        self.name, self.module, self.source, self.replaces = name, module, source, replaces
        self.counter = counter   # the wrapper's launch count in ``module``
        self.cases = []          # (ms, plain_ms, library_ms, bound_ms, bound_by)
        self.max_abs_err = 0.0

    def as_json(self, launches):
        ms = sum(c[0] for c in self.cases)
        lib = [c[2] for c in self.cases]
        widest = max(self.cases, key=lambda c: c[3])
        return {
            "name": self.name, "route": "cuda", "source": self.source, "replaces": self.replaces,
            "launches": launches, "max_abs_err": self.max_abs_err, "ms": ms,
            "plain_ms": sum(c[1] for c in self.cases),
            "bound_ms": sum(c[3] for c in self.cases), "bound_by": widest[4],
            "library_ms": None if None in lib else sum(lib),
        }


def reset_counts(mods, records):
    for rec in records:
        setattr(mods[rec.module], rec.counter, 0)


def read_counts(mods, records):
    return {rec.name: getattr(mods[rec.module], rec.counter) for rec in records}


@contextlib.contextmanager
def plain_kernels(mods):
    """Route every kernel wrapper to its plain torch version (for the
    on-card reference run); restores the kernels on exit."""
    swaps = [(mods["fps"], "_farthest_point_sample_cuda", "_farthest_point_sample_torch"),
             (mods["knn"], "_knn_cuda", "_knn_torch"),
             (mods["topk"], "_topk_extract_cuda", "_topk_extract_torch"),
             (mods["topk"], "_topk_extract_price_cuda", "_topk_extract_price_torch"),
             (mods["topk"], "_topk_extract_chunked_cuda", "_topk_extract_chunked_torch")]
    saved = [getattr(mod, kernel) for mod, kernel, _ in swaps]
    for mod, kernel, plain in swaps:
        setattr(mod, kernel, getattr(mod, plain))
    try:
        yield
    finally:
        for (mod, kernel, _), fn in zip(swaps, saved):
            setattr(mod, kernel, fn)


def phase_build(cuda):
    t0 = time.perf_counter()
    logs = cuda.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                say(f"  {name}: {line.strip()}")
    say(f"build: {len(logs)} libraries ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc sm_90a, into {cuda.BUILD_DIR})")


def phase_kernels(torch, ops, mods, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = [torch.rand(B, N_POINTS, 3, generator=gen, device=dev)]
    for npoint in (1024, 128, 16):                       # the SA levels' FPS chain
        x.append(ops.gather(x[-1], mods["fps"]._farthest_point_sample_torch(x[-1], npoint)))

    k1 = KernelRecord("fps", "fps", "patchaugnet_tpu_torch/csrc/fps.cu", "patchaugnet_tpu/ops/pallas/fps.py:64")
    for level in range(3):
        pts, m = x[level], x[level + 1].shape[1]
        n = pts.shape[1]
        got = ops.farthest_point_sample(pts, m)
        want = mods["fps"]._farthest_point_sample_torch(pts, m)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fps SA{level}: kernel indices differ from the plain version")
        ms = time_ms(torch, lambda: ops.farthest_point_sample(pts, m), 20)
        plain = time_ms(torch, lambda: mods["fps"]._farthest_point_sample_torch(pts, m), 2)
        b_ms, b_by = bound(B * n * 12 + B * m * 4, B * (m - 1) * n * 10)
        k1.cases.append((ms, plain, None, b_ms, b_by))
        measured(f"K1 fps SA{level} (b,n,m)=({B},{n},{m})",
                 f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), indices equal")
    same = torch.ones(B, N_POINTS, 3, device=dev)
    if ops.farthest_point_sample(same, 1024).count_nonzero().item() != 0:
        raise AssertionError("fps: an all-equal cloud must pick index 0 throughout")
    say("K1 fps: all-equal cloud picks index 0 throughout")

    k2 = KernelRecord("knn", "knn", "patchaugnet_tpu_torch/csrc/knn.cu", "patchaugnet_tpu/ops/pallas/knn.py:96")
    for level in range(3):
        pts, qry, k = x[level], x[level + 1], 20
        n, m = pts.shape[1], qry.shape[1]
        gi, gd = ops.knn(pts, qry, k)
        ri, rd = mods["knn"]._knn_torch(pts, qry, k)
        torch.cuda.synchronize()
        err = (gd - rd).abs().max().item()
        if not torch.equal(gi, ri) or err > 1e-6:
            raise AssertionError(f"knn SA{level}: kernel differs from the plain version (d2 err {err})")
        k2.max_abs_err = max(k2.max_abs_err, err)
        dist = ops.pairwise_sqdist(qry, pts)
        ms = time_ms(torch, lambda: ops.knn(pts, qry, k), 20)
        plain = time_ms(torch, lambda: mods["knn"]._knn_torch(pts, qry, k), 3)
        lib = time_ms(torch, lambda: torch.topk(dist, k, dim=-1, largest=False), 10)
        pair_ms = time_ms(torch, lambda: ops.pairwise_sqdist(qry, pts), 10)
        del dist
        b_ms, b_by = bound(B * (n + m) * 12 + B * m * k * 8, B * m * n * 10)
        k2.cases.append((ms, plain, lib, b_ms, b_by))
        measured(f"K2 knn SA{level} (b,n,m,k)=({B},{n},{m},{k})",
                 f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.topk on the distance matrix "
                 f"{lib:.4f} ms (+{pair_ms:.4f} ms to form it), bound {b_ms:.4f} ms ({b_by}), "
                 f"indices equal, d2 max abs err {err:.3g}")
    gi, _ = ops.knn(same, same[:, :64], 20)
    if not torch.equal(gi, torch.arange(20, dtype=torch.int32, device=dev).expand(B, 64, 20)):
        raise AssertionError("knn: an all-equal cloud must return indices 0..k-1")
    say("K2 knn: all-equal cloud returns indices 0..k-1")

    k3 = KernelRecord("topk_extract", "topk", "patchaugnet_tpu_torch/csrc/topk.cu",
                      "patchaugnet_tpu/ops/pallas/knn.py:201")
    for level in range(3):
        unknown, known, k = x[level], x[level + 1], 3
        dist = ops.pairwise_sqdist(unknown, known)          # (B, m, n) as three_nn forms it
        m, n = dist.shape[1], dist.shape[2]
        gi, gv = ops.topk_extract(dist, k)
        ri, rv = mods["topk"]._topk_extract_torch(dist, k)
        torch.cuda.synchronize()
        err = (gv - rv).abs().max().item()
        if not torch.equal(gi, ri) or err > 1e-6:
            raise AssertionError(f"topk FP{level}: kernel differs from the plain version (err {err})")
        k3.max_abs_err = max(k3.max_abs_err, err)
        ms = time_ms(torch, lambda: ops.topk_extract(dist, k), 20)
        plain = time_ms(torch, lambda: mods["topk"]._topk_extract_torch(dist, k), 3)
        lib = time_ms(torch, lambda: torch.topk(dist, k, dim=-1, largest=False), 10)
        del dist
        b_ms, b_by = bound(B * m * n * 4 + B * m * k * 8, B * m * n)
        k3.cases.append((ms, plain, lib, b_ms, b_by))
        measured(f"K3 topk_extract FP{level} (b,m,n,k)=({B},{m},{n},{k})",
                 f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.topk {lib:.4f} ms, "
                 f"bound {b_ms:.4f} ms ({b_by}), indices equal, value max abs err {err:.3g}")
    tied = torch.randint(0, 4, (B, 1024, 128), generator=gen, device=dev).float()
    for k in (3, 20):
        if not all(torch.equal(a, b) for a, b in zip(ops.topk_extract(tied, k),
                                                     mods["topk"]._topk_extract_torch(tied, k))):
            raise AssertionError(f"topk: tied matrix differs from the plain version at k={k}")
    say("K3 topk_extract: tied matrix (values in {0,1,2,3}) matches the plain version at k=3 and k=20")
    return [k1, k2, k3]


def check_equal(torch, what, got, want):
    """Indices and values exactly equal (K3-K6 round nothing differently
    from their plain versions)."""
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        err = (got[1] - want[1]).abs().max().item()
        raise AssertionError(f"{what}: kernel differs from the plain version (value err {err})")


def phase_emd_kernels(torch, ops, mods, dev):
    """K4-K6 at the auction's shapes, against their plain versions."""
    topk = mods["topk"]
    gen = torch.Generator(device=dev).manual_seed(3)
    x1 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    x2 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    neg_base = torch.sqrt(ops.pairwise_sqdist(x1, x2)) - 3.0     # as the fused sweep forms it
    price = torch.rand(EMD_B, EMD_N, generator=gen, device=dev) * 0.05
    tail_ids = torch.randperm(EMD_N, generator=gen, device=dev)[:EMD_TAIL_ROWS].sort().values
    tail = neg_base[:, tail_ids]                                   # the active-set gather

    k6 = KernelRecord("topk_extract_price", "topk", "patchaugnet_tpu_torch/csrc/topk.cu",
                      "patchaugnet_tpu/ops/pallas/knn.py:286", counter="price_launches")
    for label, base in (("full sweep", neg_base), ("active-set tail", tail)):
        b, m, n = base.shape
        check_equal(torch, f"K6 {label}", ops.topk_extract_price(base, price, 2),
                    topk._topk_extract_price_torch(base, price, 2))
        ms = time_ms(torch, lambda: ops.topk_extract_price(base, price, 2), 20)
        plain = time_ms(torch, lambda: topk._topk_extract_price_torch(base, price, 2), 3)
        summed = base + price[:, None, :]
        lib = time_ms(torch, lambda: torch.topk(summed, 2, dim=-1, largest=False), 10)
        add_ms = time_ms(torch, lambda: base + price[:, None, :], 10)
        del summed
        b_ms, b_by = bound(b * m * n * 4 + b * n * 4 + b * m * 2 * 8, 2 * b * m * n)
        k6.cases.append((ms, plain, lib, b_ms, b_by))
        measured(f"K6 topk_extract_price {label} (b,m,n,k)=({b},{m},{n},2)",
                 f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.topk on the sum {lib:.4f} ms "
                 f"(+{add_ms:.4f} ms to form it), bound {b_ms:.4f} ms ({b_by}), indices and values equal")
    for k in (3, 8, 32):
        check_equal(torch, f"K6 generic k={k}", ops.topk_extract_price(tail, price, k),
                    topk._topk_extract_price_torch(tail, price, k))
    ms8 = time_ms(torch, lambda: ops.topk_extract_price(tail, price, 8), 20)
    measured(f"K6 generic k=8 on the tail shape ({EMD_B},{EMD_TAIL_ROWS},{EMD_N})", f"kernel {ms8:.4f} ms")
    tied_base = torch.randint(0, 4, (EMD_B, EMD_TAIL_ROWS, EMD_N), generator=gen, device=dev).float()
    tied_price = torch.randint(0, 3, (EMD_B, EMD_N), generator=gen, device=dev).float() * 0.5
    for k in (2, 20):
        check_equal(torch, f"K6 tied k={k}", ops.topk_extract_price(tied_base, tied_price, k),
                    topk._topk_extract_price_torch(tied_base, tied_price, k))
    say("K6 topk_extract_price: generic k=3/8/32 and tied base and price (k=2, 20) equal the plain version")

    k4 = KernelRecord("topk_extract_chunked", "topk", "patchaugnet_tpu_torch/csrc/topk.cu",
                      "patchaugnet_tpu/ops/pallas/knn.py:330", counter="chunked_launches")
    c1 = torch.rand(1, CHUNKED_N, 3, generator=gen, device=dev)
    c2 = torch.rand(1, CHUNKED_N, 3, generator=gen, device=dev)
    cprice = torch.rand(1, CHUNKED_N, generator=gen, device=dev) * 0.05
    # the negated value of one 4096-row chunk of the row-chunked sweep
    chunk = -(3.0 - torch.sqrt(ops.pairwise_sqdist(c1[:, :4096], c2)) - cprice[:, None, :])
    got = ops.topk_extract_chunked(chunk, 2)
    check_equal(torch, "K4 vs flat K3", got, ops.topk_extract(chunk, 2))
    check_equal(torch, "K4 vs plain", got, topk._topk_extract_torch(chunk, 2))
    ms = time_ms(torch, lambda: ops.topk_extract_chunked(chunk, 2), 20)
    plain = time_ms(torch, lambda: topk._topk_extract_chunked_torch(chunk, 2, 64), 3)
    flat = time_ms(torch, lambda: ops.topk_extract(chunk, 2), 20)
    lib = time_ms(torch, lambda: torch.topk(chunk, 2, dim=-1, largest=False), 10)
    b_ms, b_by = bound(chunk.numel() * 4 + 4096 * 2 * 8, chunk.numel())
    k4.cases.append((ms, plain, lib, b_ms, b_by))
    measured(f"K4 topk_extract_chunked (b,m,n,k)=(1,4096,{CHUNKED_N},2), 64 chunks",
             f"two K3 kernel launches {ms:.4f} ms, flat K3 {flat:.4f} ms, plain {plain:.4f} ms, torch.topk {lib:.4f} ms, "
             f"bound {b_ms:.4f} ms ({b_by}), equal to flat K3 and to the plain version")
    del chunk

    del neg_base, tail
    return [k4, k6]


def phase_serving(torch, mods, records, dev):
    from patchaugnet_tpu_torch import configs, serving
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    model = seeded_init_(get_model("patch_aug_net", configs.PATCH_AUG_NET),
                         torch.Generator().manual_seed(0))
    forward = serving.build_forward_fn(model, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    requests = [torch.rand(B, N_POINTS, 3, generator=gen, device=dev) for _ in range(REQUESTS)]
    forward(requests[0])                                  # warm-up
    torch.cuda.synchronize()

    reset_counts(mods, records)
    t0 = time.perf_counter()
    descs = [forward(x) for x in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(mods, records)
    measured(f"serving {REQUESTS} requests of {B} x {N_POINTS} points",
             f"{wall * 1e3:.2f} ms, kernel launches {counts}")
    for rec in records:
        want = 3 * REQUESTS if rec.name in DESCRIPTOR_KERNELS else 0
        if counts[rec.name] != want:
            raise AssertionError(f"{rec.name}: {counts[rec.name]} launches in serving, expected {want}")

    for d in descs:
        if d.shape != (B, 256) or not torch.isfinite(d).all():
            raise AssertionError(f"descriptor batch {tuple(d.shape)} not finite (B, 256)")
        norm_err = (d.norm(dim=-1) - 1).abs().max().item()
        if norm_err > 1e-5:
            raise AssertionError(f"descriptors not unit-norm (max |norm - 1| = {norm_err})")

    with torch.inference_mode():
        ref = model(requests[0])
        with plain_kernels(mods):
            before = read_counts(mods, records)
            plain = model(requests[0])
            if read_counts(mods, records) != before:
                raise AssertionError("the plain run launched a kernel")
    for name in ("center_idx_origin", "sample_idx_origin"):
        for level, (a, b) in enumerate(zip(getattr(ref, name), getattr(plain, name))):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}[{level}]: kernel path differs from the plain path")
    desc_err = (ref.global_desc - plain.global_desc).abs().max().item()
    served_err = (ref.global_desc - descs[0]).abs().max().item()
    if desc_err > 1e-5 or served_err > 1e-5:
        raise AssertionError(f"descriptors differ: plain {desc_err}, served {served_err}")
    say(f"serving: provenance indices equal to the plain path; descriptor max abs err {desc_err:.3g} "
        f"(plain), {served_err:.3g} (served vs direct)")
    del ref, plain, descs

    for batch, iters in THROUGHPUT_BATCHES:
        clouds = torch.rand(batch, N_POINTS, 3, generator=gen, device=dev)
        forward(clouds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = forward(clouds)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / iters
        if not torch.isfinite(out).all():
            raise AssertionError(f"B={batch}: non-finite descriptors")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        measured(f"throughput B={batch}",
                 f"{batch / sec:.1f} descriptors/s ({sec * 1e3:.2f} ms per batch, "
                 f"{iters} batches), peak memory {peak:.2f} GiB")
    return counts


def check_launches(counts, want, what):
    for name, count in counts.items():
        if count != want.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {count} times, expected {want.get(name, 0)}")


def phase_emd(torch, ops, mods, records, dev):
    """The reconstruction-loss path: ``emd_loss`` at the reference call site."""
    from patchaugnet_tpu_torch import losses

    emd = mods["emd"]
    gen = torch.Generator(device=dev).manual_seed(4)
    pc1 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    pc2 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    ops.auction_emd(pc1, pc2, EMD_EPS, 8)                   # warm-up
    torch.cuda.synchronize()

    x = pc1.clone().requires_grad_()
    reset_counts(mods, records)
    t0 = time.perf_counter()
    loss = losses.emd_loss(x, pc2, EMD_EPS, EMD_ITERS)
    loss.backward()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(mods, records)
    iters, unass = emd.iterations, emd.unassigned
    check_launches(counts, {"topk_extract_price": iters + 1}, "emd_loss")
    if not (torch.isfinite(loss) and torch.isfinite(x.grad).all()) or x.grad.shape != pc1.shape:
        raise AssertionError("emd_loss: non-finite loss or gradient")
    # every launch at most as long as a full-width sweep (phase 2's time;
    # the active-set tail's are shorter)
    k6_full_ms = next(r for r in records if r.name == "topk_extract_price").cases[0][0]
    k6_share = counts["topk_extract_price"] * k6_full_ms / call_ms
    measured(f"emd_loss forward+backward ({EMD_B},{EMD_N},3) eps={EMD_EPS} iters={EMD_ITERS}",
             f"{call_ms:.3f} ms per call, {iters} iterations ({call_ms / iters:.4f} ms per iteration), "
             f"{unass} rows unassigned at exit, loss {loss.item():.6f}, K6 launches {counts['topk_extract_price']}, "
             f"K6 at most {k6_share:.1%} of the call")

    dist, assignment = ops.auction_emd(pc1, pc2, EMD_EPS, EMD_ITERS)
    with plain_kernels(mods):
        before = read_counts(mods, records)
        plain_dist, plain_assignment = ops.auction_emd(pc1, pc2, EMD_EPS, EMD_ITERS)
        if read_counts(mods, records) != before:
            raise AssertionError("the plain auction launched a kernel")
    if not (torch.equal(assignment, plain_assignment) and torch.equal(dist, plain_dist)):
        raise AssertionError("auction: the kernel path's assignment differs from the plain path's")
    unique = min(int(a.unique().numel()) for a in assignment)
    say(f"EMD: assignment and distances equal to the plain-kernel run on the card; "
        f"min unique assignments per cloud {unique}/{EMD_N}, mean sqdist {dist.mean().item():.6f}")

    for label, kw in (("unass_floor=41", {"unass_floor": 41}),
                      ("eps_schedule=(10, 1)", {"eps_schedule": (10.0, 1.0)})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist, assignment = ops.auction_emd(pc1, pc2, EMD_EPS, EMD_ITERS, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        unique = min(int(a.unique().numel()) for a in assignment)
        measured(f"auction_emd forward, {label}",
                 f"{ms:.3f} ms, {emd.iterations} iterations, {emd.unassigned} unassigned at exit, "
                 f"min unique {unique}/{EMD_N}, mean sqdist {dist.mean().item():.6f}")

    # a row-chunked auction (two 4096-row chunks of 8192 columns): each
    # chunk's top-2 is too wide for the TPU's flat tile, so it runs K4
    c1 = torch.rand(1, CHUNKED_N, 3, generator=gen, device=dev)
    c2 = torch.rand(1, CHUNKED_N, 3, generator=gen, device=dev)
    saved = os.environ.get("PCR_EMD_SWEEP")
    os.environ["PCR_EMD_SWEEP"] = "chunked"
    try:
        reset_counts(mods, records)
        t0 = time.perf_counter()
        dist, assignment = ops.auction_emd(c1, c2, EMD_EPS, CHUNKED_ITERS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        chunked_counts = read_counts(mods, records)
        sweeps = emd.iterations + 1
        # two K4 calls per sweep (one per 4096-row chunk), two K3 kernel
        # launches each, all counted under K4
        check_launches(chunked_counts, {"topk_extract_chunked": 4 * sweeps}, "row-chunked auction")
        with plain_kernels(mods):
            plain_dist, plain_assignment = ops.auction_emd(c1, c2, EMD_EPS, CHUNKED_ITERS)
    finally:
        if saved is None:
            del os.environ["PCR_EMD_SWEEP"]
        else:
            os.environ["PCR_EMD_SWEEP"] = saved
    if not (torch.equal(assignment, plain_assignment) and torch.equal(dist, plain_dist)):
        raise AssertionError("row-chunked auction: the kernel path differs from the plain path")
    measured(f"row-chunked auction (1,{CHUNKED_N},3), {CHUNKED_ITERS} iterations",
             f"{ms:.3f} ms, K4 kernel launches {chunked_counts['topk_extract_chunked']}, "
             f"assignment equal to the plain-kernel run")
    return counts, chunked_counts


def main():
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from patchaugnet_tpu_torch import ops, serving
    from patchaugnet_tpu_torch.ops import cuda

    mods = {name: importlib.import_module(f"patchaugnet_tpu_torch.ops.{name}")
            for name in ("fps", "knn", "topk", "emd")}
    smi = card_line()
    CARD = smi
    say(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    dev = serving.resolve_device("cuda")
    phase_build(cuda)
    records = phase_kernels(torch, ops, mods, dev) + phase_emd_kernels(torch, ops, mods, dev)
    serving_counts = phase_serving(torch, mods, records, dev)
    emd_counts, chunked_counts = phase_emd(torch, ops, mods, records, dev)

    # each kernel's launches on its paths: K1-K3 serving, K6 emd_loss, K4
    # the row-chunked auction (each run counts only its own kernels)
    launches = {name: serving_counts[name] + emd_counts[name] + chunked_counts[name]
                for name in serving_counts}
    # K5 (``topk_extract_pair``) is K3's function by K3's kernel, on no path
    # (the JAX package dispatches it nowhere): its line repeats K3's times
    k3 = next(r for r in records if r.name == "topk_extract")
    k5 = KernelRecord("topk_extract_pair", "topk", k3.source, "patchaugnet_tpu/ops/pallas/knn.py:177")
    k5.cases, k5.max_abs_err = k3.cases, k3.max_abs_err
    launches[k5.name] = 0
    say(json.dumps({"kernels": [rec.as_json(launches[rec.name]) for rec in records + [k5]]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
