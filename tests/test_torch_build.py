"""The CUDA kernels' build and binding, checked without a card: every
wrapper's ctypes argument list matches its C entry point in ``csrc/`` (a
mismatch would cut pointers or shift arguments at the first launch), the
library name follows the source and flags, and a wrapper given a tensor
that is neither on the CPU nor on a CUDA card raises instead of running."""
import ctypes
import re

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.attention import (attention, attention_decode,
                                           attention_decode_paged,
                                           flash_attention_bwd)
from repro_torch.kernels.gemm import (Epilogue, Prologue, gemm_fused,
                                      gemm_fused_bwd)
from repro_torch.kernels.gemm import backward as gemm_backward
from repro_torch.kernels import dropout_residual_layernorm, rope

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


def _c_signature(source: str, entry: str) -> list:
    match = re.search(rf"\bint\s+{entry}\s*\(([^)]*)\)\s*\{{", source)
    assert match, f"{entry} not found"
    types = []
    for param in match.group(1).split(","):
        param = " ".join(param.split())
        ctype = param.rsplit(" ", 1)[0].replace(" *", "*")
        assert ctype in _C_TYPES, param
        types.append(_C_TYPES[ctype])
    return types


@pytest.mark.parametrize("kernel", kernels.KERNELS, ids=lambda k: k.name)
def test_argtypes_match_the_c_entry_point(kernel):
    source = kernel.source.read_text()
    assert 'extern "C"' in source
    assert "repro_error_string" in source
    assert _c_signature(source, kernel.entry) == kernel.argtypes


def test_every_source_is_a_kernel():
    """Each csrc/*.cu is the source of one kernel of KERNELS, so build_all
    and the launch counters cover all ten."""
    assert sorted(k.source.name for k in kernels.KERNELS) \
        == sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert len(kernels.KERNELS) == 10


@pytest.mark.parametrize("kernel", kernels.KERNELS, ids=lambda k: k.name)
def test_every_source_notes_what_it_replaces_and_its_bound(kernel):
    head = kernel.source.read_text()[:4000]
    assert "Replaces the TPU kernel" in head
    assert "What bounds it on an H100" in head


def test_library_name_follows_source_and_flags():
    names = {k.lib_path.name for k in kernels.KERNELS}
    assert len(names) == len(kernels.KERNELS)
    assert all(p.startswith("lib") and p.endswith(".so") for p in names)
    assert _build.BUILD_DIR.name == "build"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_launch_counts_reset():
    for k in kernels.KERNELS:
        k.launches = 3
    assert set(kernels.launch_counts().values()) == {3}
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("op", ["gemm", "attention", "decode", "paged",
                                "gemm_bwd", "attention_bwd", "rope",
                                "fused_norm"])
def test_wrappers_refuse_other_devices(op):
    """A tensor on neither the CPU nor the card (here the meta device) is
    refused, and no launch is counted."""
    kernels.reset_launch_counts()
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        if op == "gemm":
            gemm_fused(torch.empty(8, 16, **meta), torch.empty(16, 8, **meta))
        elif op == "attention":
            q = torch.empty(1, 2, 8, 64, **meta)
            attention(q, q, q, causal=True)
        elif op == "gemm_bwd":
            gemm_fused_bwd(torch.empty(8, 16, **meta),
                           torch.empty(16, 8, **meta),
                           torch.empty(8, 8, **meta), epilogue=Epilogue(),
                           prologue=Prologue())
        elif op == "attention_bwd":
            q = torch.empty(1, 2, 8, 64, **meta)
            flash_attention_bwd(q, q, q, q, torch.empty(1, 2, 8, device="meta"),
                                q, causal=True)
        elif op == "rope":
            rope(torch.empty(1, 2, 8, 64, **meta),
                 torch.empty(8, 64, device="meta"),
                 torch.empty(8, 64, device="meta"))
        elif op == "fused_norm":
            x = torch.empty(4, 64, **meta)
            dropout_residual_layernorm(x, x, torch.empty(64, **meta),
                                       torch.empty(64, **meta), 7,
                                       dropout_p=0.1)
        elif op == "decode":
            q = torch.empty(1, 2, 1, 64, **meta)
            attention_decode(q, q.expand(1, 2, 8, 64), q.expand(1, 2, 8, 64),
                             torch.empty(1, dtype=torch.int32, device="meta"))
        else:
            q = torch.empty(1, 4, 2, 64, **meta)
            pool = torch.empty(3, 2, 16, 64, **meta)
            idx = dict(dtype=torch.int32, device="meta")
            attention_decode_paged(q, pool, pool, torch.empty(1, 2, **idx),
                                   torch.empty(1, **idx))
    assert set(kernels.launch_counts().values()) == {0}


def test_dgamma_partial_rows_match_the_kernel():
    """The wrapper sizes the dA launch's dgamma partials by the row block of
    the kernel's norm-transpose pass."""
    source = (_build.CSRC / "gemm_bwd_da.cu").read_text()
    rows = int(re.search(r"constexpr int NR_ROWS = (\d+);", source).group(1))
    assert rows == gemm_backward.ROWS_PER_PARTIAL


def test_dbias_partial_rows_match_the_kernel():
    """The wrapper sizes the operand pass's dbias partials by its row
    block."""
    source = (_build.CSRC / "gemm_bwd_g.cu").read_text()
    rows = int(re.search(r"constexpr int TR = (\d+);", source).group(1))
    assert rows == gemm_backward.ROWS_PER_BIAS_PARTIAL


def test_mainloop_tile_widths_match_the_kernels():
    """The tile widths the wrapper picks from are the ones the dA and dB
    launches dispatch on, and its tile rows the mainloop's."""
    for name in ("gemm_bwd_da.cu", "gemm_bwd_db.cu"):
        source = (_build.CSRC / name).read_text()
        widths = sorted(int(w) for w in re.findall(r"case (\d+):", source))
        assert tuple(widths) == gemm_backward.TILE_WIDTHS, name
    header = (_build.CSRC / "gemm_sm90.cuh").read_text()
    rows = int(re.search(r"constexpr int BM = (\d+);", header).group(1))
    assert rows == gemm_backward.TILE_ROWS


def test_profile_helpers_sort_kernels_and_merge_intervals():
    """The serving profile files each device kernel under its family and
    counts overlapping device intervals once."""
    from repro_torch.launch import profile_serve as ps
    assert ps.family("void (anonymous namespace)::gemm_fused_kernel<128>"
                     "(sm90::Params, (anonymous namespace)::Chain)") \
        == "gemm_fused"
    assert ps.family("(anonymous namespace)::gemm_fused_rows_kernel("
                     "__nv_bfloat16 const*, __nv_bfloat16 const*, "
                     "__nv_bfloat16*, float*, int, float)") == "gemm_fused"
    assert ps.family("void (anonymous namespace)::gemm_fused_splitk_kernel"
                     "<256>(sm90::Params)") == "gemm_fused"
    assert ps.family("(anonymous namespace)::gemm_fused_reduce_kernel("
                     "float const*, int, int, int, (anonymous namespace)::"
                     "Chain)") == "gemm_fused"
    assert ps.family("flash_fwd_kernel<64>") == "flash_attention_fwd"
    assert ps.family("void (anonymous namespace)::flash_decode_kernel<64, "
                     "16, false>(decode_split::Params)") == "flash_decode"
    assert ps.family("void (anonymous namespace)::flash_decode_paged_kernel"
                     "<64, 64, true>(decode_split::Params)") \
        == "flash_decode_paged"
    assert ps.family("void (anonymous namespace)::gemm_bwd_g_kernel<2, false>"
                     "((anonymous namespace)::GSrc, __nv_bfloat16*, "
                     "__nv_bfloat16*, float*, int)") == "gemm_bwd_g"
    assert ps.family("(anonymous namespace)::gemm_bwd_g_a_kernel("
                     "__nv_bfloat16 const*, __nv_bfloat16 const*, "
                     "float const*, __nv_bfloat16*, int, int, int)") \
        == "gemm_bwd_g"
    assert ps.family("void (anonymous namespace)::gemm_bwd_da_kernel<256, "
                     "true>(sm90::Params)") == "gemm_bwd_da"
    assert ps.family("void (anonymous namespace)::norm_transpose_kernel"
                     "<true>(float const*, __nv_bfloat16 const*, float "
                     "const*, float const*, __nv_bfloat16 const*, "
                     "__nv_bfloat16*, float*, float*, int, int)") \
        == "gemm_bwd_da"
    assert ps.family("void (anonymous namespace)::gemm_bwd_db_kernel<64>"
                     "(sm90::Params)") == "gemm_bwd_db"
    assert ps.family("void (anonymous namespace)::flash_bwd_kernel<64>"
                     "((anonymous namespace)::BwdParams)") \
        == "flash_attention_bwd"
    assert ps.family("void (anonymous namespace)::flash_bwd_dq_convert_kernel"
                     "<128>(float const*, __nv_bfloat16*, int, int)") \
        == "flash_attention_bwd"
    assert ps.family("void (anonymous namespace)::rope_kernel<__nv_bfloat16>"
                     "(RopeArgs)") == "rope"
    assert ps.family("fused_norm_kernel<float, float>") == "fused_norm"
    assert ps.family("sm90_xmma_gemm_bf16bf16_bf16f32") == "library_matmul"
    assert ps.family("nvjet_tst_128x64_64x8_2x1_v_bz_TNT") == "library_matmul"
    assert ps.family("vectorized_elementwise_kernel") == "other_torch"
    assert ps._union_us([(0, 5), (3, 8), (10, 12), (11, 11.5)]) == 10.0


def test_profile_serve_builds_the_drafts_it_is_asked_for():
    """``--draft self`` is the target; ``layers:N`` a model of N layers
    whose blocks are views of the target's first N; anything else is
    refused."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import profile_serve as ps
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("llama-1b"), num_layers=3,
                              d_model=64, num_heads=4, num_kv_heads=2,
                              d_ff=128, vocab_size=256)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    assert ps.draft_model("self", cfg, model, params) == (model, params)
    draft, dparams = ps.draft_model("layers:2", cfg, model, params)
    assert draft.cfg.num_layers == 2 and draft.mode == model.mode
    wqk = dparams["blocks"]["attn"]["wqk"]
    assert wqk.shape[0] == 2
    assert wqk.data_ptr() == params["blocks"]["attn"]["wqk"].data_ptr()
    assert dparams["embed"] is params["embed"]
    for bad in ("layers:0", "layers:4", "skip:2", "layers:x"):
        with pytest.raises(ValueError, match="--draft"):
            ps.draft_model(bad, cfg, model, params)


def test_a_source_beside_other_headers_builds_its_own_library(tmp_path):
    """A kernel's library name hashes the headers of its own directory: an
    earlier tree's copy of an unchanged ``.cu`` whose header changed (the
    smoke's A/B) is not this tree's library, and a copy with this tree's
    headers is."""
    from repro_torch.kernels.attention import decode
    ours = decode.PAGED_KERNEL
    for name, edit in (("same", False), ("edited", True)):
        d = tmp_path / name
        d.mkdir()
        (d / ours.source.name).write_bytes(ours.source.read_bytes())
        for header in _build.CSRC.glob("*.cuh"):
            text = header.read_bytes()
            if edit and header.name == "decode_split.cuh":
                text += b"// an earlier body\n"
            (d / header.name).write_bytes(text)
        other = _build.CudaKernel("baseline", str(d / ours.source.name),
                                  ours.entry, ours.argtypes)
        assert (other.lib_path == ours.lib_path) is not edit
