"""The attention kernels at head_dim 256 (recurrentgemma-2b's) against
their plain versions, on the card: the flash forward (one q tile and two
K/V stages a block) causal in a window, not causal, ragged and at the MQA
head counts of recurrentgemma-2b's local blocks; the contiguous decode
kernel over a ring that wraps past its window and the paged kernel at
pages 16 and 64, 1 and 4 query tokens (the few-row and many-row bodies,
q's fragments read from shared memory), several splits merged in the
launch, paged bitwise equal to contiguous, two calls bitwise equal, a CUDA
graph's replay equal to the eager call; and the flash backward (64 key
rows a block, the head dim split between its warpgroups) against its plain
version at the forward's cases, dk and dv bitwise across two calls, and
through kernel-mode autograd.

Marked ``cuda``: skipped on a machine without a CUDA card. On the card:

  python -m pytest -q -m cuda tests/test_torch_cuda_d256.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.attention import (attention, combine_splits,
                                           decode_partials_paged_ref,
                                           decode_partials_ref,
                                           flash_attention_bwd,
                                           flash_attention_bwd_ref,
                                           flash_attention_fwd,
                                           flash_attention_fwd_ref,
                                           flash_decode, flash_decode_paged)
from repro_torch.serve.kv_cache import gather_pages

pytestmark = pytest.mark.cuda

D = 256


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(rng, shape, dev):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=dev, dtype=torch.bfloat16)


def _close(got, want, rtol=2e-2, rms_frac=2e-2):
    """|got - want| <= rtol |want| + rms_frac * rms(want), as the head_dim
    64 and 128 card tests hold the kernels (bf16 P, sums in another
    order)."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    atol = rms_frac * want.pow(2).mean().sqrt().item()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


FWD_CASES = {
    # b, h, hkv, sq, skv, kwargs
    "mqa_window": (2, 10, 1, 600, 600, dict(causal=True, window=256)),
    "mqa_causal": (1, 10, 1, 300, 300, dict(causal=True)),
    "noncausal_cross": (1, 4, 2, 70, 200, dict(causal=False)),
    "gqa_softcap": (1, 4, 2, 200, 200, dict(causal=True, softcap=5.0)),
    "ragged": (3, 2, 1, 131, 131, dict(causal=True)),
}


def _fwd_inputs(case, dev, seed=5):
    """q and k as views of one packed q|k projection where sq == skv, v a
    view of its own, as the model passes them."""
    b, h, hkv, sq, skv, kw = FWD_CASES[case]
    rng = np.random.default_rng(seed)
    if sq == skv:
        qk = _rand(rng, (b, sq, (h + hkv) * D), dev)
        q = qk[..., :h * D].reshape(b, sq, h, D).transpose(1, 2)
        k = qk[..., h * D:].reshape(b, sq, hkv, D).transpose(1, 2)
    else:
        q = _rand(rng, (b, h, sq, D), dev)
        k = _rand(rng, (b, hkv, skv, D), dev)
    v = _rand(rng, (b, skv, hkv * D), dev).reshape(b, skv, hkv, D
                                                    ).transpose(1, 2)
    return q, k, v, kw


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_fwd_d256_matches_plain(dev, case):
    """out within 2e-2 relative + 2% of its RMS, lse within 1e-4; one
    launch a call; two calls bit for bit."""
    q, k, v, kw = _fwd_inputs(case, dev)
    before = kernels.launch_counts()["flash_attention_fwd"]
    out, lse = flash_attention_fwd(q, k, v, **kw)
    again = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_fwd"] == before + 2
    want, want_lse = flash_attention_fwd_ref(q, k, v, **kw)
    _close(out, want)
    _close(lse, want_lse, 1e-4, 1e-4)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


def _bwd_inputs(case, dev, seed=6):
    """q, k, v, out, lse and dO of a case: q and k strided views of the
    packed q|k projection (where sq == skv), dO the strided cotangent
    autograd hands over."""
    q, k, v, kw = _fwd_inputs(case, dev, seed)
    b, h, sq, _ = q.shape
    rng = np.random.default_rng(seed + 1)
    do = _rand(rng, (b, sq, h, D), dev).transpose(1, 2)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    return (q, k, v, out, lse, do), kw


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_bwd_d256_matches_plain(dev, case):
    """The main kernel (64 key rows a block, the head dim split between
    the warpgroups, P^T and dS^T exchanged through shared memory) and the
    dq conversion against the plain version: each gradient within 2e-2
    relative + 2% of its RMS, as at head_dim 64 and 128; the MQA window
    and causal cases are recurrentgemma-2b's head counts, "ragged" a
    length that is no multiple of the 64-row tiles, "noncausal_cross" 70
    queries over 200 keys; two launches a call."""
    args, kw = _bwd_inputs(case, dev)
    before = kernels.launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == before + 2
    want = flash_attention_bwd_ref(*args, **kw)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


def test_flash_bwd_d256_dk_dv_are_reproducible(dev):
    """Two calls: dk and dv bit for bit (a block walks all 10 query heads
    of its key head and sums them in a fixed order); dq, reduce-added over
    key tiles in an order that changes from run to run, within one bf16
    rounding + 0.1% of its RMS."""
    args, kw = _bwd_inputs("mqa_window", dev)
    first = flash_attention_bwd(*args, **kw)
    second = flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    _close(first[0], second[0], 2 ** -7, 1e-3)


def test_flash_bwd_d256_through_autograd(dev):
    """Kernel-mode autograd of ``attention`` at head_dim 256 launches the
    backward kernel (main + conversion) and its grads equal the plain
    backward's on the forward's out and lse."""
    q, k, v, kw = _fwd_inputs("mqa_window", dev)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    rng = np.random.default_rng(9)
    do = _rand(rng, tuple(q.shape), dev)
    out = attention(q, k, v, **kw)
    before = kernels.launch_counts()["flash_attention_bwd"]
    out.backward(do)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == before + 2
    o, lse = flash_attention_fwd(q.detach(), k.detach(), v.detach(), **kw)
    want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o,
                                   lse, do, **kw)
    for t, w_ in zip((q, k, v), want):
        _close(t.grad, w_)


RING_CASES = {
    # b, slots, lengths, window
    "wrap_window": (4, 2048, [2335, 2100, 2048, 3000], 2048),
    "short_window": (3, 512, [700, 300, 1], 200),
    "dense": (3, 300, [300, 65, 0], None),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_flash_decode_d256_matches_plain(dev, case):
    """The ring kernel at G 10 over one kv head (recurrentgemma-2b's local
    blocks): within the head_dim 64 tolerance; an empty row gives zeros."""
    b, slots, lengths, window = RING_CASES[case]
    rng = np.random.default_rng(6)
    q = _rand(rng, (b, 1, 10, D), dev)
    k = _rand(rng, (b, 1, slots, D), dev)
    v = _rand(rng, (b, 1, slots, D), dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = kernels.launch_counts()["flash_decode"]
    got = flash_decode(q, k, v, lens, window=window)
    again = flash_decode(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_decode"] == before + 2
    o, m, l = decode_partials_ref(q, k, v, lens, window=window,
                                  scale=D ** -0.5)
    _close(got, combine_splits(o, m, l).to(q.dtype))
    assert torch.equal(got, again)
    for i, n in enumerate(lengths):
        if n == 0:
            assert float(got[i].abs().max()) == 0.0


PAGED_CASES = {
    # b, page, T, max pages, lengths, window
    "page64_t1_window": (8, 64, 1, 40, [197, 2300, 640, 1000, 64, 1500,
                                        2047, 333], 2048),
    "page16_t1": (3, 16, 1, 32, [40, 500, 0], None),
    "page64_t4": (3, 64, 4, 8, [68, 400, 4], None),
    "page32_t4_window": (2, 32, 4, 16, [300, 97], 100),
}


def _paged(case, dev):
    b, page, t, mp, lengths, window = PAGED_CASES[case]
    n_pages = b * mp + 1
    rng = np.random.default_rng(7)
    kp = _rand(rng, (n_pages, 1, page, D), dev)
    vp = _rand(rng, (n_pages, 1, page, D), dev)
    q = _rand(rng, (b, 1, 10 * t, D), dev)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, mp), np.int32)
    for i, n in enumerate(lengths):
        need = -(-n // page)
        table[i, :need] = perm[i * mp:i * mp + need]
    pt = torch.from_numpy(table).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, lens, window, t


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_flash_decode_paged_d256_matches_plain(dev, case):
    q, kp, vp, pt, lens, window, t = _paged(case, dev)
    before = kernels.launch_counts()["flash_decode_paged"]
    got = flash_decode_paged(q, kp, vp, pt, lens, window=window, q_tokens=t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_decode_paged"] == before + 1
    o, m, l = decode_partials_paged_ref(q, kp, vp, pt, lens, window=window,
                                        scale=D ** -0.5, q_tokens=t)
    _close(got, combine_splits(o, m, l).to(q.dtype))
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            assert float(got[i].abs().max()) == 0.0


def test_flash_decode_paged_d256_equals_contiguous_bitwise(dev):
    """Page 64 and one query token: the paged kernel and the contiguous
    kernel over the gathered pages share the split body and agree bit for
    bit, with and without a window."""
    q, kp, vp, pt, lens, _, _ = _paged("page64_t1_window", dev)
    for window in (None, 2048):
        paged = flash_decode_paged(q, kp, vp, pt, lens, window=window)
        dense = flash_decode(q, gather_pages(kp, pt).contiguous(),
                             gather_pages(vp, pt).contiguous(), lens,
                             window=window)
        torch.cuda.synchronize()
        assert torch.equal(paged, dense)


def test_flash_decode_paged_d256_replays_from_a_cuda_graph(dev):
    """A captured call replayed on new lengths equals the eager call (the
    merge's tickets reset by each launch)."""
    q, kp, vp, pt, lens, window, t = _paged("page64_t1_window", dev)
    flash_decode_paged(q, kp, vp, pt, lens, window=window)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode_paged(q, kp, vp, pt, lens, window=window)
    lens.copy_(torch.tensor([198, 2299, 639, 999, 63, 1499, 2048, 334],
                            dtype=torch.int32))
    graph.replay()
    want = flash_decode_paged(q, kp, vp, pt, lens, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
