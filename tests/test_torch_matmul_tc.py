"""K3's route ``sm90_tf32`` on the CPU: what the wrapper decides and
computes before it launches ``csrc/matmul_lb_sm90_tf32.cu`` (f32 in
3xTF32 on ``wgmma``).

  * :func:`route`: ``sm90_tf32`` for f32 operands a TMA map describes
    (x row-major, w N-major or K-major, 16-byte pitches and bases), at
    phi3-medium-14b's four projections in both layouts; ``fma`` off by
    one alignment (a base 4 bytes off, a pitch of an odd number of
    words, a K not a multiple of 4) and for mixed types;
  * :func:`tf32_tile` ranks as the sm90 kernel's ranking does, and the
    3xTF32 bound of the four projections is 10.74 ms (three products at
    the TF32 rate) against the FMA bound's 26.44;
  * a numpy model of the kernel's addressing and arithmetic, stage by
    stage: the A and w tiles as TMA lays them out (128-byte swizzle,
    zeros past the tensors), the transposing warps' K-major hi and lo
    tiles in the permuted K order, each thread's A fragments loaded and
    split as the kernel does, the B operand read as ``wgmma`` reads a
    K-major swizzled tile, the three products with each operand read as
    the tensor cores read TF32 (its top 19 bits), every k8 product added
    to the tensor cores' f32 sums rounding toward zero (the drift the
    card showed, ``PERF.md``), and the promotion into
    round-to-nearest f32 sums every ``TF32_PROMOTE`` stages.  Against
    the reference's ``matmul_lb`` (its Pallas kernel at its default
    interpret target) on the same numpy inputs: max |model - reference|
    <= 2e-5 |reference| + 2e-4 (the reference's own f32 tolerance,
    ``tests/test_kernels.py``), and against float64 <= 4e-6 of max
    |exact|; the model without its lo terms (1xTF32) errs at least 4x
    more; at FFN down's depth (17,920) the model without promotion errs
    more than with it;
  * the A fragment loads and the transposers' stores are conflict-free;
  * the kernel's constants and C interface against the wrapper's.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul_lb.ops import matmul_lb as jax_matmul_lb
from repro_torch.core.hopper_adapter import (HBM_BYTES_PER_S,
                                             PEAK_F32_FLOPS,
                                             PEAK_TF32_FLOPS, SM_COUNT,
                                             SMEM_PER_BLOCK)
from repro_torch.kernels.matmul_lb import kernel as K3
from repro_torch.kernels.matmul_lb.ref import matmul_ref

F32 = torch.float32
#: the full-width projections of phi3-medium-14b at 4096 tokens
FULL = [(4096, 5120, 5120), (4096, 5120, 1280), (4096, 5120, 17920),
        (4096, 17920, 5120)]


def _f32(*shape):
    return torch.zeros(shape, dtype=F32)


# ---------------------------------------------------------------- route


@pytest.mark.parametrize("m,k,n", FULL)
def test_route_of_the_projections_in_f32(m, k, n):
    x = _f32(m, k)
    assert K3.route(x, _f32(k, n)) == "sm90_tf32"
    w_k = _f32(n, k).t()
    assert K3.w_layout(w_k) == "k-major"
    assert K3.route(x, w_k) == "sm90_tf32"
    assert K3.route(x.to(torch.bfloat16), _f32(k, n).to(torch.bfloat16)) \
        == "sm90"


@pytest.mark.parametrize("case", ["x off by 4 bytes", "w off by 4 bytes",
                                  "x pitch 65 words", "w pitch 33 words",
                                  "k 130", "k-major k 130", "bf16 x",
                                  "broadcast w"])
def test_route_off_by_one_alignment_is_fma(case):
    x, w = _f32(64, 128), _f32(128, 64)
    if case == "x off by 4 bytes":
        x = _f32(1 + 64 * 128)[1:].view(64, 128)
    elif case == "w off by 4 bytes":
        w = _f32(1 + 128 * 64)[1:].view(128, 64)
    elif case == "x pitch 65 words":
        x, w = _f32(64, 65)[:, :64], _f32(64, 64)
    elif case == "w pitch 33 words":
        w = _f32(128, 33)[:, :32]
    elif case == "k 130":
        x, w = _f32(64, 130), _f32(130, 64)
    elif case == "k-major k 130":
        x, w = _f32(64, 132)[:, :130], _f32(64, 130).t()
    elif case == "bf16 x":
        x = x.to(torch.bfloat16)
    else:
        w = _f32(1, 64).expand(128, 64)
    assert K3.route(x, w) == "fma"


def test_route_takes_a_pitched_f32_operand():
    """Rows a multiple of 16 bytes apart, longer than they are wide: TMA
    describes them, so no copy."""
    assert K3.route(_f32(64, 136)[:, :128], _f32(128, 64)) == "sm90_tf32"
    assert K3.route(_f32(64, 128), _f32(128, 72)[:, :64]) == "sm90_tf32"


def test_launch_counters_by_route():
    assert set(K3.matmul_lb.launches_by_route) == set(K3.ROUTES) == {
        "sm90", "sm90_tf32", "fma"}


def test_cpu_tensors_count_no_launch():
    x, w = torch.randn(40, 64), torch.randn(64, 24)
    before = (K3.matmul_lb.launches, dict(K3.matmul_lb.launches_by_route))
    assert torch.equal(K3.matmul_lb(x, w), matmul_ref(x, w))
    assert (K3.matmul_lb.launches, K3.matmul_lb.launches_by_route) == before


# ------------------------------------------------------ tile and bound


@pytest.mark.parametrize("m,k,n", FULL + [(300, 200, 152), (8, 8, 8)])
def test_tf32_tile_takes_fewest_waves_then_fewest_ctas(m, k, n):
    def key(bn):
        ctas = -(-m // K3.TILE_M) * -(-n // bn)
        return (-(-ctas // SM_COUNT) * bn, ctas * bn, -bn)
    assert K3.tf32_tile(m, n) == min(K3.TF32_TILES, key=key)


def test_projection_bounds():
    """Three TF32 products a multiply-add at 495 TFLOP/s bound the four
    projections at 10.74 ms, where one at the FMA rate bounds them at
    26.44 ms; both are operations-bound."""
    flops = sum(2.0 * m * k * n for m, k, n in FULL)
    n_bytes = sum(4.0 * (m * k + k * n + m * n) for m, k, n in FULL)
    assert n_bytes / HBM_BYTES_PER_S < 1e-3
    tf32 = K3.TF32_PRODUCTS * flops / PEAK_TF32_FLOPS
    assert 10.73e-3 < tf32 < 10.75e-3
    assert 26.43e-3 < flops / PEAK_F32_FLOPS < 26.45e-3


# ---------------------------------- numpy model of the 3xTF32 kernel

BK = K3.TF32_BK


def _tc(v: np.ndarray) -> np.ndarray:
    """A word as the tensor cores read a TF32 operand: its top 19 bits."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v: np.ndarray, lo_terms: bool):
    """The kernel's split: hi = v's top 19 bits, lo = v - hi (exact in
    f32), or 0 (the 1xTF32 control)."""
    v = np.asarray(v, np.float32)
    hi = _tc(v)
    lo = (v - hi) if lo_terms else np.zeros_like(v)
    return hi, lo.astype(np.float32)


def _rtz(v: np.ndarray) -> np.ndarray:
    """float64 to f32, rounding toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _swz(off):
    """The 128-byte swizzle on byte offsets from a 1024-byte line."""
    return off ^ ((off >> 3) & 0x70)


def _a_tile(xt: np.ndarray) -> np.ndarray:
    """An A stage (128 rows x 32 words) as TMA writes it: row r's byte b
    at swz(r * 128 + b)."""
    words = np.zeros(128 * BK, np.float32)
    r, k = np.meshgrid(np.arange(128), np.arange(BK), indexing="ij")
    words[_swz(r * 128 + 4 * k) // 4] = xt
    return words


def _w_tile(wt: np.ndarray, kmajor: bool) -> np.ndarray:
    """A w stage (32 of K x bn) as TMA writes it: K-major, bn rows of 32
    words; N-major, bn / 32 boxes of 32 K rows x 32 columns, 4 KB
    apart."""
    bn = wt.shape[1]
    words = np.zeros(bn * BK, np.float32)
    if kmajor:
        n, k = np.meshgrid(np.arange(bn), np.arange(BK), indexing="ij")
        words[_swz(n * 128 + 4 * k) // 4] = wt.T
    else:
        k, n = np.meshgrid(np.arange(BK), np.arange(bn), indexing="ij")
        words[(n // 32 * 4096 + _swz(k * 128 + (n % 32) * 4)) // 4] = wt
    return words


def _transpose(wwords: np.ndarray, bn: int, kmajor: bool, lo_terms: bool):
    """The transposing warps' hi and lo tiles, by the kernel's index
    math: unit (nb, hf), lane a column n, words v[j][q] = K element
    4hf + j + 8q, stored as 16-byte chunk 4hf + j of row n, swizzled."""
    hi = np.zeros(bn * BK, np.float32)
    lo = np.zeros(bn * BK, np.float32)
    lane = np.arange(32)
    for u in range((bn // 32) * 2):
        nb, hf = divmod(u, 2)
        n = nb * 32 + lane
        v = np.empty((4, 4, 32), np.float32)       # [j][q][lane]
        for q in range(4):
            if kmajor:
                chunk = _swz(n * 128 + (hf + 2 * q) * 16)
                for j in range(4):
                    v[j, q] = wwords[(chunk + 4 * j) // 4]
            else:
                for j in range(4):
                    v[j, q] = wwords[_swz(nb * 4096 + (4 * hf + j + 8 * q)
                                          * 128 + lane * 4) // 4]
        for j in range(4):
            h, l_ = _split(v[j], lo_terms)
            d = n * 128 + (((4 * hf + j) ^ (n % 8)) << 4)
            for q in range(4):
                hi[(d + 4 * q) // 4] = h[q]
                lo[(d + 4 * q) // 4] = l_[q]
    return hi, lo


def _thread_rows():
    """Each consumer thread's rows r0 (and r0 + 8) and its c = lane % 4,
    over the CTA's 256 consumer threads."""
    t = np.arange(256)
    cw, tid = t // 128, t % 128
    lane = tid % 32
    r0 = cw * 64 + 16 * (tid // 32) + lane // 4
    return r0, lane % 4


def _a_words(awords: np.ndarray, r0, cq) -> np.ndarray:
    """Each thread's 16 A words: rows r0 and r0 + 8, two 16-byte chunks
    (2c, 2c + 1) a row, as the kernel loads them: [thread][row][8]."""
    out = np.empty((len(r0), 2, 8), np.float32)
    for r in range(2):
        for h in range(2):
            base = _swz((r0 + 8 * r) * 128 + (2 * cq + h) * 16)
            for i in range(4):
                out[:, r, 4 * h + i] = awords[(base + 4 * i) // 4]
    return out


def _fragment(words: np.ndarray, r0, cq, kk: int) -> np.ndarray:
    """The 128 x 8 A operand of k8 step kk: a0 (row r0, column c), a1
    (r0 + 8, c), a2 (r0, c + 4), a3 (r0 + 8, c + 4) are words 2kk, 2kk
    + 1 of the thread's eight of each row."""
    a = np.zeros((128, 8), np.float32)
    a[r0, cq] = words[:, 0, 2 * kk]
    a[r0 + 8, cq] = words[:, 1, 2 * kk]
    a[r0, cq + 4] = words[:, 0, 2 * kk + 1]
    a[r0 + 8, cq + 4] = words[:, 1, 2 * kk + 1]
    return a


def _b_operand(tile: np.ndarray, kk: int, bn: int) -> np.ndarray:
    """The 8 x bn B operand wgmma reads at k8 step kk from a K-major
    swizzled tile (descriptor start 32 kk bytes on, rows 128 bytes, 8-row
    atoms 1024 bytes apart): slot s of column n at swz(n*128 + 32kk +
    4s)."""
    s, n = np.meshgrid(np.arange(8), np.arange(bn), indexing="ij")
    return tile[_swz(n * 128 + 32 * kk + 4 * s) // 4]


def _model(x: np.ndarray, w: np.ndarray, *, kmajor: bool = False,
           bn: int | None = None, promote: int = K3.TF32_PROMOTE,
           lo_terms: bool = True) -> np.ndarray:
    m, k = x.shape
    n = w.shape[1]
    bn = bn or K3.tf32_tile(m, n)
    nk = -(-k // BK)
    tm, tn = -(-m // 128), -(-n // bn)
    xp = np.zeros((tm * 128, nk * BK), np.float32)
    xp[:m, :k] = x
    wp = np.zeros((nk * BK, tn * bn), np.float32)
    wp[:k, :n] = w
    r0, cq = _thread_rows()
    out = np.zeros((tm * 128, tn * bn), np.float32)
    for i in range(tm):
        for j in range(tn):
            acc = np.zeros((128, bn), np.float32)
            total = np.zeros((128, bn), np.float32)
            since = 0
            for kt in range(nk):
                ks = slice(kt * BK, (kt + 1) * BK)
                words = _a_words(_a_tile(xp[i * 128:(i + 1) * 128, ks]),
                                 r0, cq)
                hi_t, lo_t = _transpose(
                    _w_tile(wp[ks, j * bn:(j + 1) * bn], kmajor), bn,
                    kmajor, lo_terms)
                for kk in range(BK // 8):
                    a_hi, a_lo = _split(_fragment(words, r0, cq, kk),
                                        lo_terms)
                    b_hi = _b_operand(hi_t, kk, bn)
                    b_lo = _b_operand(lo_t, kk, bn)
                    for a_op, b_op in ((a_lo, b_hi), (a_hi, b_lo),
                                       (a_hi, b_hi)):
                        prod = (_tc(a_op).astype(np.float64)
                                @ _tc(b_op).astype(np.float64))
                        acc = _rtz(acc.astype(np.float64) + prod)
                since += 1
                if promote and since == promote and kt + 1 < nk:
                    total = (total + acc).astype(np.float32)
                    acc = np.zeros_like(acc)
                    since = 0
            out[i * 128:(i + 1) * 128, j * bn:(j + 1) * bn] = total + acc
    return out[:m, :n]


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _exact_err(got, x, w):
    exact = x.astype(np.float64) @ w.astype(np.float64)
    return np.abs(got - exact).max() / np.abs(exact).max()


# m, k, n, layout, bn: a ragged edge in every dimension, both layouts,
# both tiles; a long K of several promotions; the reference's sweep shapes
# whose f32 rows TMA describes
MODEL_CASES = [
    (200, 100, 136, "n-major", 128),
    (200, 100, 136, "k-major", 64),
    (130, 260, 72, "k-major", 128),
    (64, 64, 64, "n-major", 64),
    (128, 256, 128, "n-major", 128),
    (8, 8, 8, "k-major", 64),
]


@pytest.mark.parametrize("m,k,n,layout,bn", MODEL_CASES)
def test_tf32_model_reproduces_the_reference(m, k, n, layout, bn):
    x, w = _inputs(m, k, n, seed=m + k + n)
    got = _model(x, w, kmajor=layout == "k-major", bn=bn)
    ref = np.asarray(jax_matmul_lb(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4)
    assert _exact_err(got, x, w) <= 4e-6


@pytest.mark.parametrize("m,k,n,layout,bn", MODEL_CASES[:3])
def test_tf32_model_without_lo_terms_errs_more(m, k, n, layout, bn):
    x, w = _inputs(m, k, n, seed=m + k + n)
    kw = dict(kmajor=layout == "k-major", bn=bn)
    right = _exact_err(_model(x, w, **kw), x, w)
    one = _exact_err(_model(x, w, lo_terms=False, **kw), x, w)
    assert one >= 4 * right


def test_tf32_model_at_ffn_down_depth_needs_its_promotion():
    """FFN down's K = 17,920 (560 stages): the tensor cores' sums,
    rounding toward zero at every k8 product, drift with the range they
    sum; promoted every ``TF32_PROMOTE`` stages into round-to-nearest
    sums the model stays within the f32 gate, and without promotion it
    errs more."""
    x, w = _inputs(16, 17920, 64, seed=7)
    ref = np.asarray(jax_matmul_lb(jnp.asarray(x), jnp.asarray(w)))
    promoted = _model(x, w, bn=64)
    never = _model(x, w, bn=64, promote=0)
    np.testing.assert_allclose(promoted, ref, rtol=2e-5, atol=2e-4)
    assert _exact_err(never, x, w) > 2 * _exact_err(promoted, x, w)


def test_model_permutation_is_one_order_for_a_and_b():
    """Slot s of k8 step kk holds the same K element in A (the thread's
    word order) and in B (the transposers' chunk order): element 8s + 2kk
    for s < 4, 8(s - 4) + 2kk + 1 after, a bijection of each stage's
    32."""
    seen = []
    for kk in range(4):
        for s in range(8):
            a_elem = 8 * (s % 4) + 2 * kk + s // 4     # the thread's word
            pos = 8 * kk + s                            # byte 4 pos of a row
            r, q = divmod(pos, 4)                       # chunk r, word q
            b_elem = r + 8 * q                          # the transposers'
            assert a_elem == b_elem
            seen.append(a_elem)
    assert sorted(seen) == list(range(32))


def test_a_loads_and_transposer_stores_are_conflict_free():
    """Every quarter warp's 16-byte A loads and every transposer's
    16-byte stores (8 lanes each) fall in 8 distinct 16-byte chunks of
    the banks: one wavefront each."""
    r0, cq = _thread_rows()
    for r in range(2):
        for h in range(2):
            addr = _swz((r0 + 8 * r) * 128 + (2 * cq + h) * 16)
            for quarter in range(256 // 8):
                chunks = (addr[8 * quarter:8 * quarter + 8] % 128) // 16
                assert len(set(chunks.tolist())) == 8
    lane = np.arange(32)
    for nb in range(4):
        n = nb * 32 + lane
        for chunk in range(8):
            for kmajor in (True, False):
                if kmajor:   # the K-major loads, one chunk of each row
                    addr = _swz(n * 128 + chunk * 16)
                else:        # the stores
                    addr = n * 128 + ((chunk ^ (n % 8)) << 4)
                for quarter in range(4):
                    chunks = (addr[8 * quarter:8 * quarter + 8] % 128) // 16
                    assert len(set(chunks.tolist())) == 8


# ------------------------------------------- kernel against the wrapper


def _src() -> str:
    return K3.TF32_SOURCE.read_text()


def test_tf32_kernel_constants_match_the_wrapper():
    src = _src()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kBM") == K3.TILE_M
    assert const("kBK") == K3.TF32_BK
    assert const("kStages") == K3.TF32_STAGES
    assert const("kBStages") == K3.TF32_BSTAGES
    assert const("kTransposers") == K3.TF32_TRANSPOSERS
    inst = {int(b) for b in re.findall(r"launch<(\d+), (?:true|false)>",
                                       src)}
    assert inst == set(K3.TF32_TILES)
    for bn in K3.TF32_TILES:
        smem = (1024 + K3.TF32_STAGES * (K3.TILE_M + bn) * K3.TF32_BK * 4
                + K3.TF32_BSTAGES * 2 * bn * K3.TF32_BK * 4
                + 16 * (K3.TF32_STAGES + K3.TF32_BSTAGES))
        assert smem <= SMEM_PER_BLOCK
    # ptxas holds a 384-thread CTA to 168 registers a thread: two
    # accumulators of BN / 2, two fragment buffers of 8 and 8 A words
    # leave the rest for addresses and the loop
    assert 2 * (max(K3.TF32_TILES) // 2) + 2 * 8 + 8 <= 168 - 16
    assert "uint32_t af[2][8];" in src and "float4 x[2];" in src
    assert K3.TF32_PROMOTE >= 1
    assert const("kPromote") == K3.TF32_PROMOTE


def test_wrapper_binds_the_kernels_c_interface():
    sig = re.search(r'extern "C" int matmul_lb_sm90_tf32_forward\((.*?)\)',
                    _src(), re.S)[1]
    params = [p.strip() for p in sig.split(",")]
    assert sum(p.startswith("int ") for p in params) == 8
    assert sum("*" in p for p in params) == 3 + 1        # + stream
    assert 'lib.bind("matmul_lb_sm90_tf32_forward", 3, 8)' in \
        Path(K3.__file__).read_text()


def test_the_sweeps_copies_change_only_the_promotion_interval():
    """``launch/tf32_promote.py`` builds each interval as a copy of the
    source with another ``kPromote``: the one line it rewrites is the
    kernel's only definition of the interval."""
    from repro_torch.launch import tf32_promote as TP
    src = _src()
    assert len(TP.PROMOTE.findall(src)) == 1
    copy = TP.PROMOTE.sub("constexpr int kPromote = 7;", src)
    changed = [(a, b) for a, b in zip(src.splitlines(), copy.splitlines())
               if a != b]
    assert changed == [(f"constexpr int kPromote = {K3.TF32_PROMOTE};",
                        "constexpr int kPromote = 7;")]
    assert "promote" not in re.search(
        r'extern "C" int matmul_lb_sm90_tf32_forward\((.*?)\)', src,
        re.S)[1]
