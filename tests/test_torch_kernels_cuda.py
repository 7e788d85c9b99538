"""The port's CUDA kernels against their plain-torch versions, on the card.

This file imports neither jax nor the reference, so it also runs where
only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tests marked ``cuda`` skip without a GPU.  Tolerances: the (W, P, 3) sums
within rtol 1e-5 (the kernel and torch add in different orders); the
apply pass within atol 1e-6 (the same elementwise operations in the same
order — the kernels are built without fused multiply-add — save the sum
over P externals, whose order torch picks).  B4 (K-Means E/M): idx equal
wherever the two best scores do not nearly tie (top-2 f64 margin above
1e-5 (|best| + 1)); counts exactly; sums within 1e-5 of an f64 sum
relative to the f64 sum of |x|.  B5 (SSD scan): y and h within 1e-4 of
the largest magnitude of the plain version's (f32 sums of up to Q·N terms,
which cancel, in another order; products in split TF32 on the tensor
cores; the cumulative decay a warp prefix sum), bitwise repeatable.
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core.packing import quantize_rows
from repro_torch.kernels.gossip_blend import gossip_gates
from repro_torch.kernels.gossip_blend.kernel import (SOURCE, gossip_apply,
                                                     gossip_apply_w,
                                                     gossip_apply_w_resident,
                                                     gossip_reduce,
                                                     gossip_reduce_w,
                                                     gossip_reduce_w_resident)
from repro_torch.kernels.gossip_blend.ref import (
    gossip_apply_plain, gossip_apply_w_plain, gossip_apply_w_resident_plain,
    gossip_reduce_plain, gossip_reduce_w_plain,
    gossip_reduce_w_resident_plain)
from repro_torch.kernels.kmeans_assign.kernel import SOURCE as KM_SOURCE
from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_w
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_plain
from repro_torch.kernels.parzen_blend import parzen_blend
from repro_torch.kernels.parzen_blend.kernel import (parzen_apply,
                                                     parzen_reduce)
from repro_torch.kernels.parzen_blend.ref import (parzen_apply_plain,
                                                  parzen_blend_ref,
                                                  parzen_reduce_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_chunked
from repro_torch.kernels.ssd_scan.kernel import SOURCE as SSD_SOURCE
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain

W, R, LANE, BR = 4, 2624, 512, 64
EPS, LR, ALPHA = 0.05, 0.07, 0.3
RANGES = {"full": (0, R), "partial": (768, 1408), "empty": (1408, 1408),
          "unaligned": (100, 1000)}


def make_operands(p, wire, seed, device):
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((W, R, LANE))).astype(np.float32)
    dw = (0.01 * rng.standard_normal((W, R, LANE))).astype(np.float32)
    side = np.where(rng.permutation(W * p) % 2 == 0, 0.5, -0.5)
    ext = (w[:, None] - side.reshape(W, p, 1, 1) * dw[:, None]
           + 0.02 * rng.standard_normal((W, p, R, LANE))).astype(np.float32)
    ops = {"w": torch.from_numpy(w), "dw": torch.from_numpy(dw),
           "ext": torch.from_numpy(ext), "scales": None}
    if wire == "int8":
        ops["ext"], ops["scales"] = quantize_rows(ops["ext"], BR)
    return {k: None if v is None else v.to(device) for k, v in ops.items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_build_targets_hopper_and_is_keyed_by_source():
    assert SOURCE in K.kernel_sources()
    flags = " ".join(K.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    lib = K.library_path(SOURCE)
    assert lib.parent == K.BUILD_DIR and lib == K.library_path(SOURCE)
    assert lib.name.startswith("gossip_blend-")


def test_kernel_source_names_what_it_replaces():
    text = pathlib.Path(SOURCE).read_text()
    for name in ("gossip_reduce_w_resident_pallas",
                 "gossip_apply_w_resident_pallas", "Bound:"):
        assert name in text


def test_batched_source_builds_apart_and_names_what_it_replaces():
    """B2 and B3 build from B1's source, one library for the six kernels,
    each with its own C entry point."""
    blend = [s for s in K.kernel_sources() if s.parent == SOURCE.parent]
    assert blend == [SOURCE]
    text = pathlib.Path(SOURCE).read_text()
    for name in ("gossip_reduce_w_pallas", "gossip_apply_w_pallas",
                 "gossip_reduce_pallas", "gossip_apply_pallas",
                 "parzen_reduce_pallas", "parzen_apply_pallas", "Bound:"):
        assert name in text
    for entry in ("gossip_reduce_w_resident(", "gossip_apply_w_resident(",
                  "gossip_reduce_w(", "gossip_apply_w(", "gossip_reduce(",
                  "gossip_apply(", "parzen_reduce(", "parzen_apply("):
        assert f"int {entry}" in text


def test_kmeans_source_builds_apart_and_names_what_it_replaces():
    """B4 has its own source and library; B6 builds from the gossip-blend
    source (its two entry points above)."""
    assert KM_SOURCE in K.kernel_sources()
    assert set(K.kernel_sources()) == {SOURCE, KM_SOURCE, SSD_SOURCE}
    assert K.library_path(KM_SOURCE).name.startswith("kmeans_assign-")
    text = pathlib.Path(KM_SOURCE).read_text()
    for name in ("kmeans_assign_pallas", "Bound:", "int kmeans_assign(",
                 "int kmeans_assign_plan("):
        assert name in text


@pytest.mark.cuda
@pytest.mark.parametrize("rng_name", sorted(RANGES))
@pytest.mark.parametrize("wire,p,elastic", [("f32", 1, False),
                                            ("int8", 1, True),
                                            ("f32", 2, True),
                                            ("int8", 3, False)])
def test_cuda_kernels_match_plain(cuda_device, wire, p, elastic, rng_name):
    ops = make_operands(p, wire, 2, cuda_device)
    rr = RANGES[rng_name]
    if wire == "int8" and rng_name == "unaligned":
        rr = (128, 1024)    # int8 partitions are block_rows-aligned
    args = (ops["w"], ops["dw"], ops["ext"])
    K.reset_launch_counts()
    acc = gossip_reduce_w_resident(*args, rr, ops["scales"], block_rows=BR)
    acc_p = gossip_reduce_w_resident_plain(*args, rr, ops["scales"],
                                           block_rows=BR)
    torch.testing.assert_close(acc, acc_p, rtol=1e-5, atol=0)
    gates = gossip_gates(acc_p, EPS)
    inv = 1.0 / (gates.sum(dim=1) + 1.0)
    kw = {"elastic": elastic, "elastic_alpha": ALPHA, "block_rows": BR}
    out = gossip_apply_w_resident(*args, gates, inv, LR, rr, ops["scales"],
                                  **kw)
    out_p = gossip_apply_w_resident_plain(*args, gates, inv, LR, rr,
                                          ops["scales"], **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-6)
    assert K.launch_counts() == {"gossip_reduce_w_resident": 1,
                                 "gossip_apply_w_resident": 1}


@pytest.mark.cuda
def test_cuda_reduce_is_deterministic(cuda_device):
    ops = make_operands(1, "int8", 3, cuda_device)
    runs = [gossip_reduce_w_resident(ops["w"], ops["dw"], ops["ext"],
                                     (768, 1408), ops["scales"],
                                     block_rows=BR) for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])


@pytest.mark.cuda
def test_cuda_rejects_bad_operands(cuda_device):
    ops = make_operands(1, "f32", 4, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        gossip_reduce_w_resident(ops["w"].transpose(0, 1).contiguous()
                                 .transpose(0, 1), ops["dw"], ops["ext"],
                                 (0, R), block_rows=BR)
    with pytest.raises(ValueError, match="several devices"):
        gossip_reduce_w_resident(ops["w"], ops["dw"].cpu(), ops["ext"],
                                 (0, R), block_rows=BR)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("p,elastic", [(1, False), (3, True), (8, False)])
def test_cuda_batched_kernels_match_plain(cuda_device, p, elastic, masked):
    """B2r/B2a (W=4, a partition mask or none) and B3r/B3a (worker 0's
    slice) against their plain versions."""
    ops = make_operands(p, "f32", 5, cuda_device)
    w, dw, ext = ops["w"], ops["dw"], ops["ext"]
    mask = None
    if masked:
        mask = torch.zeros(R * LANE, device=cuda_device)
        mask[1000:R * LANE // 2 + 333] = 1.0
        mask = mask.reshape(R, LANE)
    kw = {"eps": EPS, "elastic": elastic, "elastic_alpha": ALPHA}
    K.reset_launch_counts()
    acc = gossip_reduce_w(w, dw, ext, mask)
    acc_p = gossip_reduce_w_plain(w, dw, ext, mask)
    torch.testing.assert_close(acc, acc_p, rtol=1e-5, atol=0)
    gates = gossip_gates(acc_p, EPS)
    inv = 1.0 / (gates.sum(dim=1) + 1.0)
    out = gossip_apply_w(w, dw, ext, gates, inv, mask, **kw)
    out_p = gossip_apply_w_plain(w, dw, ext, gates, inv, mask, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-6)
    acc1 = gossip_reduce(w[0], dw[0], ext[0])
    acc1_p = gossip_reduce_plain(w[0], dw[0], ext[0])
    torch.testing.assert_close(acc1, acc1_p, rtol=1e-5, atol=0)
    g1 = gossip_gates(acc1_p, EPS)
    inv1 = 1.0 / (g1.sum() + 1.0)
    out1 = gossip_apply(w[0], dw[0], ext[0], g1, inv1, **kw)
    out1_p = gossip_apply_plain(w[0], dw[0], ext[0], g1, inv1, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out1, out1_p, rtol=0, atol=1e-6)
    assert K.launch_counts() == {"gossip_reduce_w": 1, "gossip_apply_w": 1,
                                 "gossip_reduce": 1, "gossip_apply": 1}


@pytest.mark.cuda
def test_cuda_batched_reduce_is_deterministic_and_bounds_p(cuda_device):
    ops = make_operands(2, "f32", 6, cuda_device)
    mask = torch.ones((R, LANE), device=cuda_device)
    runs = [gossip_reduce_w(ops["w"], ops["dw"], ops["ext"], mask)
            for _ in range(3)]
    runs1 = [gossip_reduce(ops["w"][0], ops["dw"][0], ops["ext"][0])
             for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    for r in runs1[1:]:
        assert torch.equal(r, runs1[0])
    big = ops["ext"][0, :1].expand(9, R, LANE).contiguous()
    with pytest.raises(ValueError, match="P=9 externals exceed"):
        gossip_reduce(ops["w"][0], ops["dw"][0], big)


# ---------------------------------------------------------------------------
# B4 (kmeans_assign) and B6 (parzen_blend)
# ---------------------------------------------------------------------------

def check_b4(x, w, out, out_p):
    """B4 against its plain version (see the module docstring)."""
    idx, sums, counts = out
    wn, k, d = w.shape
    xd, wd = x.double(), w.double()
    scores = -2.0 * torch.matmul(xd, wd.transpose(1, 2)) + \
        (wd * wd).sum(-1)[:, None, :]
    if k > 1:
        top = torch.topk(scores, 2, dim=-1, largest=False).values
        off_tie = (top[..., 1] - top[..., 0]) > 1e-5 * (top[..., 0].abs() + 1)
    else:
        off_tie = torch.ones_like(idx, dtype=torch.bool)
    assert not bool(((idx != out_p[0]) & off_tie).any())
    flat = (idx.long() + torch.arange(wn, device=x.device)[:, None] * k) \
        .reshape(-1)
    exact = torch.bincount(flat, minlength=wn * k).reshape(wn, k).float()
    torch.testing.assert_close(counts, exact, rtol=0, atol=0)
    xs = xd.expand(wn, -1, -1).reshape(-1, d)
    s64 = torch.zeros((wn * k, d), dtype=torch.float64, device=x.device)
    a64 = torch.zeros_like(s64)
    s64.index_add_(0, flat, xs)
    a64.index_add_(0, flat, xs.abs())
    assert bool(((sums.double().reshape(-1, d) - s64).abs()
                 <= 1e-5 * a64).all())


@pytest.mark.cuda
@pytest.mark.parametrize("wn,shared,m,k,d", [
    (1, True, 1000, 10, 10), (1, True, 300, 3, 5), (1, True, 2048, 256, 64),
    (1, True, 777, 1024, 128), (1, True, 500, 40, 200),
    (8, False, 64, 8, 6), (6, True, 999, 7, 17), (64, False, 500, 10, 10),
    # the streamed kernel at the paper's and Fig. 7's shapes
    (1, True, 10**6, 10, 10), (1, True, 10**6, 50, 10),
    (1, True, 10**6, 100, 10),
    # just under its limit (K * D = 1024, D = 16) and just over it
    (1, True, 5000, 64, 16), (1, True, 5000, 65, 16), (1, True, 5000, 10, 17),
    # worker stride 3330 floats: worker 1's rows are not 16-byte aligned,
    # and each worker's one tile (13320 bytes) is not a multiple of 16
    (3, False, 333, 10, 10),
    # worker stride 10250 floats: worker 1's rows are not 16-byte aligned,
    # but its first two tiles are full 512-row tiles (20480 bytes)
    (3, False, 1025, 10, 10),
    # a ragged last tile (161 rows of 40 bytes) at a large M
    (1, True, 100001, 10, 10)])
def test_cuda_kmeans_assign_matches_plain(cuda_device, wn, shared, m, k, d):
    g = torch.Generator(device=cuda_device).manual_seed(m + k + d)
    x = torch.randn(((m, d) if shared else (wn, m, d)), generator=g,
                    device=cuda_device)
    w = torch.randn((wn, k, d), generator=g, device=cuda_device)
    K.reset_launch_counts()
    out = kmeans_assign_w(x, w)
    torch.cuda.synchronize()
    assert K.launch_counts() == {"kmeans_assign": 1}
    assert out[0].dtype == torch.int32 and tuple(out[0].shape) == (wn, m)
    check_b4(x, w, out, kmeans_assign_plain(x, w))
    if not shared:       # one worker's slice alone gives the same answer
        one = kmeans_assign_w(x[wn - 1], w[wn - 1:])
        assert torch.equal(one[0][0], out[0][wn - 1])
        assert torch.equal(one[2][0], out[2][wn - 1])


@pytest.mark.cuda
def test_cuda_kmeans_assign_counts_are_exact_above_2_24(cuda_device):
    m = 2**25 + 3
    x = torch.randn((m, 2), device=cuda_device)
    counts = kmeans_assign_w(x, torch.zeros((1, 1, 2),
                                            device=cuda_device))[2]
    assert float(counts[0]) == float(torch.tensor(m, dtype=torch.float32))
    w = torch.tensor([[[0.0, 0.0], [1e3, 0.0]]], device=cuda_device)
    counts = kmeans_assign_w(x[:2**24 + 1], w)[2]     # one cluster takes all
    assert counts.tolist() == [[16777216.0, 0.0]]


@pytest.mark.cuda
def test_cuda_kmeans_assign_routes_by_shape(cuda_device):
    """The streamed kernel runs at D <= 16 with K * D <= 1024 (the K-Means
    path's shapes), the tiled kernel at every other shape: the kernel names
    a profiler trace of three calls sees."""
    kernels = ("assign_stream_kernel", "assign_partial_kernel")
    for kernel, shapes in (
            ("assign_stream_kernel",
             ((10, 10), (100, 10), (64, 16), (1024, 1), (1, 2))),
            ("assign_partial_kernel",
             ((65, 16), (10, 17), (1024, 128), (40, 200)))):
        for k, d in shapes:
            x = torch.randn((1000, d), device=cuda_device)
            w = torch.randn((1, k, d), device=cuda_device)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    kmeans_assign_w(x, w)
                torch.cuda.synchronize()
            ran = {n for n in kernels for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and n in e.name}
            assert ran == {kernel}, (k, d, ran)


@pytest.mark.cuda
def test_cuda_kmeans_assign_long_chains_stay_accurate(cuda_device):
    """10^7 positive samples, all nearest one prototype: every sum is one
    long accumulation, within 1e-5 of the f64 sum."""
    m, k, d = 10**7, 10, 10
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.rand((m, d), generator=g, device=cuda_device)
    w = torch.full((1, k, d), 100.0, device=cuda_device)
    w[0, 0] = 0.5
    w[0, 1:] += torch.arange(1, k, device=cuda_device)[:, None]
    idx, sums, counts = kmeans_assign_w(x, w)
    assert not bool(idx.any())
    assert counts.tolist() == [[float(m)] + [0.0] * (k - 1)]
    s64 = x.double().sum(0)
    assert bool(((sums[0, 0].double() - s64).abs() <= 1e-5 * s64).all())
    assert not bool(sums[0, 1:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,d", [(10**6, 10, 10), (2**16, 1024, 128),
                                   (10**6, 100, 10)])
def test_cuda_kmeans_assign_is_deterministic(cuda_device, m, k, d):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((m, d), generator=g, device=cuda_device)
    w = torch.randn((1, k, d), generator=g, device=cuda_device)
    runs = [kmeans_assign_w(x, w) for _ in range(3)]
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r, runs[0]))


@pytest.mark.cuda
def test_cuda_kmeans_assign_rejects_bad_operands(cuda_device):
    x = torch.randn((100, 4), device=cuda_device)
    w = torch.randn((1, 3, 4), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kmeans_assign_w(torch.randn((4, 100), device=cuda_device).T, w)
    with pytest.raises(ValueError, match="several devices"):
        kmeans_assign_w(x.cpu(), w)
    with pytest.raises(ValueError, match="float32"):
        kmeans_assign_w(x.half(), w)
    with pytest.raises(ValueError, match="D=300 exceeds"):
        kmeans_assign_w(torch.randn((10, 300), device=cuda_device),
                        torch.randn((1, 2, 300), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("side,gate", [(0.5, 1.0), (-0.5, 0.0)])
def test_cuda_parzen_kernels_match_plain(cuda_device, side, gate):
    ops = make_operands(1, "f32", 7, cuda_device)
    w, dw = ops["w"][0], ops["dw"][0]
    ext = (w - side * dw).contiguous()
    K.reset_launch_counts()
    acc = parzen_reduce(w, ext, dw)
    acc_p = parzen_reduce_plain(w, ext, dw)
    torch.testing.assert_close(acc, acc_p, rtol=1e-5, atol=0)
    runs = [parzen_reduce(w, ext, dw) for _ in range(2)]
    assert all(torch.equal(r, acc) for r in runs)
    g = torch.tensor([gate], device=cuda_device)
    out = parzen_apply(w, ext, dw, g, eps=EPS)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, parzen_apply_plain(w, ext, dw, g,
                                                       eps=EPS),
                               rtol=0, atol=1e-6)
    assert K.launch_counts() == {"parzen_reduce": 3, "parzen_apply": 1}
    flat = w.reshape(-1)[:-5]
    out, got = parzen_blend(flat, ext.reshape(-1)[:-5], dw.reshape(-1)[:-5],
                            EPS)
    ref, want = parzen_blend_ref(flat, ext.reshape(-1)[:-5],
                                 dw.reshape(-1)[:-5], EPS)
    assert float(got) == float(want) == gate
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# B5: the Mamba-2 chunked SSD scan
# ---------------------------------------------------------------------------

def test_ssd_source_builds_apart_and_names_what_it_replaces():
    assert SSD_SOURCE in K.kernel_sources()
    assert K.library_path(SSD_SOURCE).name.startswith("ssd_scan-")
    text = pathlib.Path(SSD_SOURCE).read_text()
    for name in ("ssd_scan_pallas", "Bound:", "int ssd_scan("):
        assert name in text


def ssd_operands(Bb, S, H, P, N, device, seed=0):
    """Inputs drawn like the model's: dt = softplus(.), A = -exp(A_log)
    over linspace(1, 16) per row (rows differ), B and C shared by the
    heads."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((Bb, S, H, P), generator=g, device=device)
    dt = torch.nn.functional.softplus(
        torch.randn((Bb, S, H), generator=g, device=device))
    A = -torch.linspace(1.0, 16.0, H, device=device) * torch.arange(
        1, Bb + 1, device=device)[:, None] / Bb
    B = torch.randn((Bb, S, N), generator=g, device=device)
    C = torch.randn((Bb, S, N), generator=g, device=device)
    return x, dt, A.contiguous(), B, C


def assert_near(ours, ref, tol=1e-4):
    err = float((ours - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("Bb,S,H,P,N,chunk", [
    (2, 128, 4, 8, 16, 32), (1, 64, 8, 64, 128, 64), (3, 96, 1, 4, 4, 32),
    (2, 64, 32, 16, 16, 8),          # reduced mamba2: chunk 8
    (1, 256, 2, 160, 128, 128),      # three P-tiles, the last narrower
    (1, 96, 3, 8, 5, 96),            # chunk neither a power of 2 nor 32k
    (4, 512, 32, 64, 128, 128)])     # the serve shape at S = 512
def test_cuda_ssd_scan_matches_plain(cuda_device, Bb, S, H, P, N, chunk):
    ops = ssd_operands(Bb, S, H, P, N, cuda_device, seed=S + P)
    K.reset_launch_counts()
    y, h = ssd_scan_chunked(*ops, chunk)
    torch.cuda.synchronize()
    assert K.launch_counts() == {"ssd_scan": 1}
    yp, hp = ssd_scan_plain(*ops, chunk)
    assert_near(y, yp)
    assert_near(h, hp)
    for _ in range(2):
        y2, h2 = ssd_scan_chunked(*ops, chunk)
        assert torch.equal(y2, y) and torch.equal(h2, h)


@pytest.mark.cuda
@pytest.mark.parametrize("Bb,S,H,P,N,chunk", [
    (1, 96, 3, 8, 5, 96),            # Q 96, N 5: neither a tile multiple
    (1, 64, 2, 160, 16, 8),          # Q 8, P 160: a 32-wide last P-tile
    (2, 96, 2, 5, 7, 32)])           # P 5, N 7: 4-byte copies
def test_cuda_ssd_scan_ragged_tensor_core_tiles(cuda_device, Bb, S, H, P, N,
                                                chunk):
    """Q, N and P off the 16 x 8 x 8 tensor-core tiles: padded with zeros
    in shared memory, never in device memory."""
    ops = ssd_operands(Bb, S, H, P, N, cuda_device, seed=S + N)
    y, h = ssd_scan_chunked(*ops, chunk)
    yp, hp = ssd_scan_plain(*ops, chunk)
    assert_near(y, yp)
    assert_near(h, hp)
    y2, h2 = ssd_scan_chunked(*ops, chunk)
    assert torch.equal(y2, y) and torch.equal(h2, h)


def cancelling_operands(Bb, S, H, P, N, device, seed=0):
    """x alternating in sign along S over B and C that share a large
    constant component plus small noise, dt near constant and slow decay:
    y is ~1% of its terms, so products that keep only TF32's ~3 digits miss
    the 1e-4 gate."""
    g = torch.Generator(device=device).manual_seed(seed)
    sign = (-1.0) ** torch.arange(S, device=device)
    x = sign[None, :, None, None] * (1 + 0.1 * torch.randn(
        (Bb, S, H, P), generator=g, device=device))
    dt = 0.05 + 0.001 * torch.rand((Bb, S, H), generator=g, device=device)
    A = (-0.01 * torch.linspace(1.0, 4.0, H, device=device)).expand(
        Bb, H).contiguous()
    B = 1.0 + 0.01 * torch.randn((Bb, S, N), generator=g, device=device)
    C = 1.0 + 0.01 * torch.randn((Bb, S, N), generator=g, device=device)
    return x, dt, A, B, C


@pytest.mark.cuda
def test_cuda_ssd_scan_keeps_f32_accuracy_where_sums_cancel(cuda_device):
    ops = cancelling_operands(4, 512, 32, 64, 128, cuda_device)
    y, h = ssd_scan_chunked(*ops, 128)
    yp, hp = ssd_scan_plain(*ops, 128)
    assert_near(y, yp)
    assert_near(h, hp)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])     # 1: rows off 16 bytes
def test_cuda_ssd_scan_reads_the_conv_output_in_place(cuda_device, offset):
    """x, B and C as views of the model's conv output: the kernel reads them
    at their row stride (4-byte copies where a row is off 16 bytes), and
    gives the contiguous operands' y and h bitwise."""
    Bb, S, H, P, N = 2, 256, 4, 64, 32
    g = torch.Generator(device=cuda_device).manual_seed(4)
    xbc = torch.randn((Bb, S, offset + H * P + 2 * N), generator=g,
                      device=cuda_device)[..., offset:]
    x = xbc[..., :H * P].reshape(Bb, S, H, P)
    B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    _, dt, A, _, _ = ssd_operands(Bb, S, H, P, N, cuda_device)
    y, h = ssd_scan_chunked(x, dt, A, B, C, 64)
    yc, hc = ssd_scan_chunked(x.contiguous(), dt, A, B.contiguous(),
                              C.contiguous(), 64)
    assert torch.equal(y, yc) and torch.equal(h, hc)
    ys, hs = ssd_scan(x, dt, A, B[:, :, None], C[:, :, None], chunk=64)
    assert torch.equal(ys, yc) and torch.equal(hs, hc)


@pytest.mark.cuda
def test_cuda_ssd_scan_pads_and_survives_decay_extremes(cuda_device):
    x, dt, A, B, C = ssd_operands(2, 200, 4, 16, 32, cuda_device)
    y, h = ssd_scan(x, dt, A, B[:, :, None], C[:, :, None], chunk=64)
    yp, hp = ssd_scan_plain(*[torch.nn.functional.pad(
        t, (0, 0) * (t.ndim - 2) + (0, 56)) for t in (x, dt)], A,
        *[torch.nn.functional.pad(t, (0, 0, 0, 56)) for t in (B, C)], 64)
    assert_near(y, yp[:, :200])
    assert_near(h, hp)
    ones = torch.ones((1, 64, 2, 4), device=cuda_device)
    y, h = ssd_scan(ones, torch.full((1, 64, 2), 1e-4, device=cuda_device),
                    torch.tensor([-100.0, -1e-3], device=cuda_device),
                    torch.ones((1, 64, 1, 8), device=cuda_device),
                    torch.ones((1, 64, 1, 8), device=cuda_device), chunk=32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())


@pytest.mark.cuda
def test_cuda_ssd_scan_rejects_bad_operands(cuda_device):
    x, dt, A, B, C = ssd_operands(1, 256, 2, 8, 16, cuda_device)
    with pytest.raises(ValueError, match="exceed"):
        ssd_scan_chunked(x, dt, A, B, C, 256)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_chunked(x, dt, A, B.transpose(1, 2).contiguous()
                         .transpose(1, 2), C, 64)
    with pytest.raises(ValueError, match="several devices"):
        ssd_scan_chunked(x, dt, A.cpu(), B, C, 64)
    with pytest.raises(NotImplementedError, match="no backward"):
        ssd_scan_chunked(x.requires_grad_(), dt, A, B, C, 64)
    with torch.no_grad():
        ssd_scan_chunked(x, dt, A, B, C, 64)
