"""The RoPE and fused-norm kernels' partitions and arithmetic, on the CPU.

``csrc/rope.cu`` gives each thread ``vec`` elements (16 bytes) of both
halves of a (b, h, s) row, lays ``rp`` row lanes of ``nv`` threads in a
block, and walks units of one position and up to ``UNROLL * rp`` rows;
``csrc/fused_norm.cu`` holds a row in the registers of ``tpr`` threads,
``EPT`` elements each, and sums it in a fixed order (a thread's slots, the
xor shuffle tree, the row's warps). Here: the constants are the kernels',
the partitions cover every element exactly once under every grid, and an
emulation of each kernel in numpy fp32 (the same partition, the same
rounding points, the same order of sums) is held against the port's plain
versions and the reference's Pallas kernels in interpret mode.

RoPE: the emulation equals the port's plain version bit for bit, as the
kernel does on the card, and is within 1e-6 (fp32) or one ulp (bf16) of
the reference's interpret-mode kernel (plus 1e-6 in bf16): XLA on the CPU
fuses one of the two products of each output into a multiply-add, which
one depending on the shape, so no single rounding order gives its fp32
bits.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.fused_norm import fused_dropout_residual_layernorm
from repro.kernels.fused_norm.kernel import (dropout_keep_mask as
                                             j_kernel_keep_mask)
from repro.kernels.rope import rope_pallas
from repro.kernels.rope import rope_tables as j_rope_tables

from repro_torch.kernels import _build
from repro_torch.kernels.fused_norm import (
    dropout_keep_mask_ref, fused_dropout_residual_layernorm_ref)
from repro_torch.kernels.fused_norm import kernel as norm_kernel
from repro_torch.kernels.rope import kernel as rope_kernel
from repro_torch.kernels.rope import rope_ref

F32 = np.float32
M32 = 0xFFFFFFFF
# csrc/fused_norm.cu: row elements a thread holds, threads a block, the
# widths of a row's thread group (launch_width), the widest register row
EPT, BLOCK, ROW_THREADS = 16, 256, (32, 64, 128, 256, 512)
MAX_REG_D = EPT * ROW_THREADS[-1]


def _norm_plan(d, elem_size, vector):
    """The register kernel's cut of a d-wide row, as launch_width makes it:
    ``tpr`` threads a row, the least width that holds d at EPT elements a
    thread; ``vec`` elements a slot (16 bytes, or 1 in the scalar branch),
    ``slots`` a thread, ``groups`` rows a block of ``threads``."""
    tpr = next(n for n in ROW_THREADS if d <= n * EPT)
    vec = 16 // elem_size if vector else 1
    threads = max(tpr, BLOCK)
    return dict(tpr=tpr, vec=vec, slots=EPT // vec, groups=threads // tpr,
                threads=threads)


def _bf16(a):
    """fp32 values rounded to bf16 (to nearest even), back in fp32."""
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(
        torch.bfloat16).float().numpy()


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, e - 8)


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# ---------------------------------------------------------------------------
# the constants
# ---------------------------------------------------------------------------

def test_rope_constants_match_the_kernel():
    src = (_build.CSRC / "rope.cu").read_text()
    assert _const(src, "UNROLL") == rope_kernel.UNROLL
    assert _const(src, "THREADS") == rope_kernel.THREADS
    assert rope_kernel.UNROLL >= 2     # loads in flight before the first use


def test_norm_constants_match_the_kernel():
    src = (_build.CSRC / "fused_norm.cu").read_text()
    assert _const(src, "EPT") == EPT
    assert _const(src, "BLOCK") == BLOCK
    assert _const(src, "MAX_TPR") == ROW_THREADS[-1]
    widths = re.findall(r"a\.d <= (\d+) \* EPT\) return launch_rows<T, (\d+),",
                        src)
    assert [int(a) for a, b in widths] == [int(b) for a, b in widths] \
        == list(ROW_THREADS[:-1])
    assert "return launch_rows<T, 512, VECTOR>" in src
    assert MAX_REG_D == 8192 < norm_kernel.MAX_D


# ---------------------------------------------------------------------------
# RoPE: the partition
# ---------------------------------------------------------------------------

def _rope_units(plan, grid):
    """(block, unit) in the order the blocks of a grid take them."""
    for blk in range(grid):
        for u in range(blk, plan["units"], grid):
            yield blk, u


def _rope_items(plan, rows, u):
    """(k, rows, columns, valid) of every thread of a block at unit u: the
    row each thread loads at step k, the first column of its vector, and
    whether the row exists."""
    tid = np.arange(plan["threads"])
    j, lane = tid % plan["nv"], tid // plan["nv"]
    s = u // plan["chunks"]
    row0 = (u - s * plan["chunks"]) * plan["rp"] * rope_kernel.UNROLL + lane
    for k in range(rope_kernel.UNROLL):
        r = row0 + k * plan["rp"]
        yield k, s, r, j * plan["vec"], r < rows


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,s,d", [(4, 32, 256, 64), (4, 8, 1024, 64),
                                     (2, 3, 131, 64), (2, 5, 200, 128),
                                     (1, 1, 7, 72), (3, 40, 5, 256)])
def test_rope_partition_covers_every_element_once(b, h, s, d, elem):
    """Under grids of 1 block, a few, one a unit and the card's, every
    element of both halves of every row is written exactly once; a block
    fits THREADS, and at the llama shapes one unit holds a position's
    rows, so each table vector is loaded once a position and thread."""
    plan = rope_kernel.rope_plan(b * h, s, d, elem)
    half = d // 2
    assert plan["threads"] <= rope_kernel.THREADS
    assert plan["vec"] * elem == 16
    for grid in (1, 5, plan["units"], min(plan["units"], 132 * 6)):
        hits = np.zeros((b * h, s, d), int)
        for _, u in _rope_units(plan, grid):
            for _, pos, r, col, valid in _rope_items(plan, b * h, u):
                for e in range(plan["vec"]):
                    ok = valid & (col + e < half)
                    hits[r[ok], pos, col[ok] + e] += 1
                    hits[r[ok], pos, col[ok] + e + half] += 1
        assert (hits == 1).all()
    if d == 64 and b * h <= 4 * 32:
        assert plan["chunks"] == 1


def test_rope_plan_at_the_main_path_shapes():
    """llama-1b (32 heads, 8 kv heads, head_dim 64) in bf16: 4 threads a
    row, each with one 16-byte vector of either half; training q and k
    at B 4 as one unit a position of 32 and 8 row lanes."""
    q = rope_kernel.rope_plan(4 * 32, 1024, 64, 2)
    k = rope_kernel.rope_plan(4 * 8, 1024, 64, 2)
    assert (q["nv"], q["rp"], q["chunks"], q["threads"]) == (4, 32, 1, 128)
    assert (k["nv"], k["rp"], k["chunks"], k["threads"]) == (4, 8, 1, 32)
    with pytest.raises(ValueError, match="threads a row"):
        rope_kernel.rope_plan(8, 16, 4096 * 2 + 2, 2)


# ---------------------------------------------------------------------------
# RoPE: the arithmetic
# ---------------------------------------------------------------------------

def _emulate_rope(x, sin, cos, sign, elem, grid):
    """The kernel in numpy fp32: each thread's table vectors of its unit's
    position (times sin_sign), then x1 c1 + (-x2) s1 and x2 c2 + x1 s2 with
    the products and the sum rounded separately. x: (B, H, S, D) fp32
    holding values of x's type; returns the fp32 outputs."""
    b, h, s, d = x.shape
    half = d // 2
    plan = rope_kernel.rope_plan(b * h, s, d, elem)
    out = np.full(x.shape, np.nan, F32)
    for _, u in _rope_units(plan, grid):
        for _, pos, r, col, valid in _rope_items(plan, b * h, u):
            for e in range(plan["vec"]):
                c = col + e
                ok = valid & (c < half)
                rr, cc = r[ok], c[ok]
                bb, hh = rr // h, rr % h
                x1, x2 = x[bb, hh, pos, cc], x[bb, hh, pos, cc + half]
                c1, c2 = cos[pos, cc], cos[pos, cc + half]
                s1 = F32(sign) * sin[pos, cc]
                s2 = F32(sign) * sin[pos, cc + half]
                out[bb, hh, pos, cc] = (x1 * c1) + (-x2 * s1)
                out[bb, hh, pos, cc + half] = (x2 * c2) + (x1 * s2)
    return out


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,d", [(131, 64), (200, 128), (131, 128),
                                 (200, 64)])
def test_rope_emulation_matches_plain_and_reference(s, d, dtype, sign):
    """The emulation (grid of 7 blocks) equals the port's plain version
    bit for bit, in fp32 and after the bf16 rounding, and lies within 1e-6
    (fp32), or one bf16 ulp plus 1e-6 (bf16), of the reference's
    interpret-mode kernel (given -sin for the backward, as the reference's
    VJP does)."""
    b, h = 2, 3
    rng = np.random.default_rng(s * d)
    x = rng.standard_normal((b, h, s, d)).astype(F32)
    if dtype == "bfloat16":
        x = _bf16(x)
    jsin, jcos = j_rope_tables(jnp.arange(s), d)
    sin, cos = np.array(jsin), np.array(jcos)
    elem = 2 if dtype == "bfloat16" else 4
    got = _emulate_rope(x, sin, cos, sign, elem, grid=7)
    if dtype == "bfloat16":
        got = _bf16(got)
    tdt = getattr(torch, dtype)
    plain = rope_ref(torch.from_numpy(x).to(tdt),
                     torch.from_numpy(F32(sign) * sin),
                     torch.from_numpy(cos)).float().numpy()
    np.testing.assert_array_equal(got, plain)
    jdt = getattr(jnp, dtype)
    want = np.asarray(rope_pallas(jnp.asarray(x).astype(jdt),
                                  F32(sign) * jsin, jcos, interpret=True)
                      .astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        # the multiply-add moves the fp32 value by up to the fp32
        # tolerance, which an output that cancels to near zero turns into
        # more than one of its own bf16 ulps
        ulp = np.maximum(_bf16_ulp(want), _bf16_ulp(got))
        assert (np.abs(got - want) <= ulp + 1e-6).all()


def test_rope_emulation_reads_both_table_halves():
    """The kernel does not assume duplicated halves: with tables whose
    halves differ, the emulation still equals the plain version."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 2, 9, 64)).astype(F32)
    sin = rng.standard_normal((9, 64)).astype(F32)
    cos = rng.standard_normal((9, 64)).astype(F32)
    got = _emulate_rope(x, sin, cos, 1.0, 4, grid=3)
    plain = rope_ref(*map(torch.from_numpy, (x, sin, cos))).numpy()
    np.testing.assert_array_equal(got, plain)


def test_rope_scalar_branch_tail_matches_plain():
    """Half a row of 36 bf16 elements is four whole vectors and a tail of
    4: the scalar branch's guard (``n``) writes only the tail's elements."""
    rng = np.random.default_rng(4)
    x = _bf16(rng.standard_normal((2, 2, 11, 72)).astype(F32))
    sin, cos = (np.array(t) for t in j_rope_tables(jnp.arange(11), 72))
    got = _bf16(_emulate_rope(x, sin, cos, 1.0, 2, grid=4))
    plain = rope_ref(torch.from_numpy(x).to(torch.bfloat16),
                     torch.from_numpy(sin), torch.from_numpy(cos))
    np.testing.assert_array_equal(got, plain.float().numpy())


# ---------------------------------------------------------------------------
# fused norm: the partition
# ---------------------------------------------------------------------------

def _norm_columns(plan):
    """(slots, tpr, vec) columns: slot k of thread t holds vec elements at
    column (k tpr + t) vec."""
    k = np.arange(plan["slots"])[:, None, None]
    t = np.arange(plan["tpr"])[None, :, None]
    e = np.arange(plan["vec"])[None, None, :]
    return (k * plan["tpr"] + t) * plan["vec"] + e


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [8, 100, 512, 513, 1000, 2048, 3000, 4096,
                               5000, 8192])
def test_norm_partition_covers_every_column_once(d, elem):
    """In the scalar branch, and in the vector branch where d is a whole
    number of vectors: each column of the row is held by exactly one
    (thread, slot, element); tpr is the least width that holds d at EPT a
    thread, so no narrower instance would do; a thread holds EPT
    elements."""
    for vector in (False, True)[: 1 + (d * elem % 16 == 0)]:
        plan = _norm_plan(d, elem, vector)
        cols = _norm_columns(plan)
        assert cols[0].size * plan["slots"] == plan["tpr"] * EPT
        hit = np.bincount(cols[cols < d].ravel(), minlength=d)
        assert (hit == 1).all()
        narrower = [n for n in ROW_THREADS if n < plan["tpr"]]
        assert all(d > n * EPT for n in narrower)
        assert plan["threads"] == max(plan["tpr"], BLOCK)
        assert plan["groups"] * plan["tpr"] == plan["threads"]


def test_norm_plan_at_the_bench_shape():
    """d 2048: a warpgroup a row, two rows a block; fp32 four 16-byte
    vectors of x and of the residual a thread, bf16 two. No register
    instance holds a row past MAX_REG_D."""
    for elem, slots in ((4, 4), (2, 2)):
        plan = _norm_plan(2048, elem, True)
        assert (plan["tpr"], plan["groups"], plan["slots"]) == (128, 2, slots)
    with pytest.raises(StopIteration):
        _norm_plan(MAX_REG_D + 1, 4, True)


# ---------------------------------------------------------------------------
# fused norm: the arithmetic
# ---------------------------------------------------------------------------

def _lowbias32(x):
    x = np.atleast_1d(np.asarray(x, np.uint32))
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _kernel_keep(seed, row0, rows, cols, d, p):
    """The kernel's keep bits of rows row0.. at cols: idx0 = row * d
    wrapped to uint32, plus the column, wrapped again."""
    row = np.arange(row0, row0 + rows, dtype=np.uint64)
    idx0 = (row * np.uint64(d)) & np.uint64(M32)
    idx = ((idx0.reshape((-1,) + (1,) * cols.ndim) + cols.astype(np.uint64))
           & np.uint64(M32)).astype(np.uint32)
    mix = _lowbias32(np.uint32(int(seed) & M32))
    bits = _lowbias32(idx ^ mix)
    u = (bits >> np.uint32(8)).astype(F32) * F32(1.0 / (1 << 24))
    return u >= F32(p)


def _row_sum(partial):
    """(rows, tpr) per-thread partials -> (rows,) as the kernel sums them:
    the xor shuffle tree within each warp (every lane ends with the same
    value: each step adds two values that commute), then the row's warps
    in order from 0.0."""
    rows, tpr = partial.shape
    v = partial.reshape(rows, tpr // 32, 32).copy()
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, :, lanes ^ o]
    assert (v == v[:, :, :1]).all()
    total = np.zeros(rows, F32)
    for w in range(tpr // 32):
        total = total + v[:, w, 0]
    return total


def _emulate_norm(x, r, w, b, seed, p, eps, elem, vector, row0=0):
    """The register kernel in numpy fp32. x, r: (rows, d) fp32 holding
    values of x's type; w, b: (d,) fp32. Returns (normed before its cast,
    new_residual before its cast, keep, mean, var)."""
    rows, d = x.shape
    plan = _norm_plan(d, elem, vector)
    cols = _norm_columns(plan)                       # (slots, tpr, vec)
    valid = cols < d
    cc = np.where(valid, cols, 0)
    xv, rv = x[:, cc], r[:, cc]                      # (rows, slots, tpr, vec)
    keep = _kernel_keep(seed, row0, rows, cols, d, p)
    if p > 0:
        scale = F32(1.0 / (1.0 - p))
        xv = np.where(keep, xv * scale, F32(0))
    v = np.where(valid, rv + xv, F32(0))
    partial = np.zeros((rows, plan["tpr"]), F32)
    for k in range(plan["slots"]):
        for e in range(plan["vec"]):
            partial = partial + v[:, k, :, e]
    mean = _row_sum(partial) / F32(d)
    cv = v - mean[:, None, None, None]
    sq = np.zeros_like(partial)
    for k in range(plan["slots"]):
        for e in range(plan["vec"]):
            sq = sq + np.where(valid[k, :, e], cv[:, k, :, e] * cv[:, k, :, e],
                               F32(0))
    var = _row_sum(sq) / F32(d)
    inv = F32(1) / np.sqrt(var + F32(eps))
    o = (cv * inv[:, None, None, None]) * w[cc] + b[cc]
    out = np.zeros((rows, d), F32)
    res = np.zeros((rows, d), F32)
    kept = np.zeros((rows, d), bool)
    out[:, cols[valid]] = o[:, valid]
    res[:, cols[valid]] = (rv + xv)[:, valid]
    kept[:, cols[valid]] = keep[:, valid]
    return out, res, kept, mean, var


def _norm_inputs(rows, d, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(F32)
    r = (2 + rng.standard_normal((rows, d))).astype(F32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(F32)
    b = (0.1 * rng.standard_normal(d)).astype(F32)
    if dtype == "bfloat16":
        x, r = _bf16(x), _bf16(r)
    return x, r, w, b


@pytest.mark.parametrize("vector", [True, False], ids=["vector", "scalar"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,p,seed", [(1000, 0.1, 7), (2048, 0.1, -1),
                                      (4096, 0.5, 2 ** 31 - 1),
                                      (2048, 0.0, 3)])
def test_norm_emulation_matches_reference_kernel(d, p, seed, dtype, vector):
    """The emulation against the reference's interpret-mode kernel:
    new_residual (in x's type) and the keep-mask bit for bit, normed
    within 1e-5 of its scale in fp32, plus one ulp in bf16; and the
    kernel-order mean and variance within fp32 rounding of float64
    ones."""
    rows = 6
    x, r, w, b = _norm_inputs(rows, d, dtype, seed=d)
    elem = 2 if dtype == "bfloat16" else 4
    out, res, keep, mean, var = _emulate_norm(x, r, w, b, seed, p, 1e-5,
                                              elem, vector)
    if p > 0:
        np.testing.assert_array_equal(
            keep, np.asarray(j_kernel_keep_mask(jnp.int32(seed), 0,
                                                (rows, d), p)))
    jdt = getattr(jnp, dtype)
    jout, jres = fused_dropout_residual_layernorm(
        jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt),
        jnp.asarray(w), jnp.asarray(b), seed, dropout_p=p, interpret=True)
    jout = np.asarray(jout.astype(jnp.float32))
    jres = np.asarray(jres.astype(jnp.float32))
    if dtype == "bfloat16":
        out, res = _bf16(out), _bf16(res)
    np.testing.assert_array_equal(res, jres)
    tol = 1e-5 * np.abs(jout).max()
    if dtype == "bfloat16":
        tol = tol + np.maximum(_bf16_ulp(jout), _bf16_ulp(out))
    assert (np.abs(out - jout) <= tol).all()
    summed = res.astype(np.float64) if dtype == "float32" else None
    if summed is not None:
        np.testing.assert_allclose(mean, summed.mean(1), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(var, summed.var(1), rtol=1e-5)


@pytest.mark.parametrize("d", [1000, 2048, 4096])
def test_norm_emulation_matches_port_plain(d):
    """The emulation and the port's plain version: new_residual and the
    keep-mask bit for bit, normed within 1e-5 of its scale (the plain
    version sums the row in torch's order)."""
    x, r, w, b = _norm_inputs(5, d, "float32", seed=d + 1)
    out, res, keep, _, _ = _emulate_norm(x, r, w, b, 11, 0.2, 1e-5, 4, True)
    pout, pres = fused_dropout_residual_layernorm_ref(
        *map(torch.from_numpy, (x, r, w, b)), 11, dropout_p=0.2)
    np.testing.assert_array_equal(res, pres.numpy())
    np.testing.assert_array_equal(
        keep, dropout_keep_mask_ref(11, (5, d), 0.2).numpy())
    assert np.abs(out - pout.numpy()).max() <= 1e-5 * np.abs(out).max()


@pytest.mark.parametrize("d,row0", [(2048, 1 << 21), (1000, 5_000_000),
                                    (4096, (1 << 31) - 9)])
def test_norm_keep_index_wraps_mod_2_32(d, row0):
    """Rows whose index row * d passes 2^32: the kernel's uint32 idx0 plus
    the column, both wrapped, gives the reference kernel's mask at that
    row offset bit for bit, for every column a thread's slots hold."""
    plan = _norm_plan(d, 4, True)
    cols = _norm_columns(plan)
    keep = _kernel_keep(7, row0, 4, cols, d, 0.5)
    full = np.zeros((4, d), bool)
    full[:, cols[cols < d]] = keep[:, cols < d]
    want = np.asarray(j_kernel_keep_mask(7, row0, (4, d), 0.5))
    np.testing.assert_array_equal(full, want)
    np.testing.assert_array_equal(
        full, dropout_keep_mask_ref(7, (4, d), 0.5, row0=row0).numpy())
