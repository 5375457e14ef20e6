"""Model API: ``build_model(cfg, mode=..., device=..., qkv_plan=...,
mesh=..., data_axes=...)`` returns a :class:`Model` whose methods close
over the config, the mode, the device, the rung of the QKV ladder and the
mesh, and dispatch on ``cfg.family`` as
the reference's ``_build_model`` does: the decoder-only LM ('lm'), the
vision-language model ('vlm': ``forward`` and ``loss`` take a batch dict
with ``patch_embeds``; serving is text-only on its LM backbone, as in the
reference), the encoder-decoder ('encdec': ``forward``, ``loss``,
``prefill`` and ``init_cache`` take a batch dict with ``encoder_embeds``)
and the encoder ('encoder': ``forward`` and ``loss``). :func:`make_batch`
draws a training batch of any family from a torch generator, as the
reference's does from a JAX key; :class:`MadeBatches` streams them for
``train_loop``.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with a 'model' axis
and data axes) the LM's MoE blocks run ``moe_forward``'s expert- or
tensor-parallel path over it, and a rank holds its own slice of the
experts (:meth:`Model.local_params`); every other leaf is whole on every
rank. The training step over a mesh sets ``tp`` (a
``distributed.tensor_parallel.TensorParallel``): then ``loss``, of every
family, takes every leaf as the rank's block under the logical rules and
splits the blocks (attention, MLP, MoE, RG-LRU and SSD), the embedding,
the head and the cross entropy over 'model'."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import DECODER_FAMILIES
from repro_torch.device import DEFAULT_DEVICE, dtype_of, resolve_device
from . import encdec as _ed
from . import encoder as _enc
from . import lm as _lm
from . import vlm as _vlm
from .attention import QKV_PLANS
from .common import init_params, logical_axes
from .moe import local_experts

MODES = ("kernel", "reference")
FAMILIES = ("lm", "vlm", "encdec", "encoder")
_PARAM_DEFS = {"lm": _lm.lm_param_defs, "vlm": _vlm.vlm_param_defs,
               "encdec": _ed.encdec_param_defs,
               "encoder": _enc.encoder_param_defs}


def _refuse(what: str, family: str):
    if family == "encoder" and what in ("init_cache", "prefill",
                                        "decode_step"):
        # the reference's message (its encoder-only archs skip decode)
        raise NotImplementedError("encoder-only archs have no decode step")
    raise NotImplementedError(
        f"{what}: the {family!r} family has no paged path (the reference's "
        "PagedEngine serves decoder-only LMs)")


@dataclasses.dataclass
class Model:
    cfg: object
    mode: str
    device: torch.device
    defs: dict
    qkv_plan: str = "rope_fused"
    mesh: object = None
    data_axes: tuple = ("data",)
    tp: object = None

    def init(self, seed: int = 0, dtype=None) -> dict:
        """Seeded random parameters, each leaf drawn in the param type and
        cast once to ``dtype`` before the next is drawn: by default the
        compute type, the one copy serving keeps; training passes
        ``cfg.param_dtype`` for its fp32 masters."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.defs, gen, self.device,
                           cast=dtype_of(dtype or self.cfg.compute_dtype))

    def axes(self) -> dict:
        """The tree of each parameter's logical axes (the sharding rules'
        input, ``distributed.sharding``)."""
        return logical_axes(self.defs)

    def resolve_policies(self, *, batch: int = 1,
                         seq_len: int | None = None,
                         decode_len: int | None = None, shard=None) -> dict:
        """The kernel policies this model's kernels use for a (batch,
        seq_len) bucket, {op kind: KernelPolicy}, resolved (and the
        autotuner's memo warmed) by ``core.autotune.policies_for_model``;
        ``seq_len`` defaults to min(max_seq_len, 4096), as the reference's."""
        from repro_torch.core import autotune

        seq_len = seq_len if seq_len is not None else \
            min(self.cfg.max_seq_len, 4096)
        return autotune.policies_for_model(self.cfg, batch=batch,
                                           seq_len=seq_len,
                                           decode_len=decode_len, shard=shard)

    def local_params(self, params) -> dict:
        """This rank's parameters over the model's mesh: each MoE layer's
        experts cut to the rank's 'model' slice (the expert dim under "ep",
        the FFN hidden dim under "tp"), every other leaf as it is (views,
        no copy). Without a mesh, ``params``."""
        if self.mesh is None:
            return params

        def walk(tree):
            return {k: (local_experts(self.cfg, v, self.mesh) if k == "moe"
                        else walk(v) if isinstance(v, dict) else v)
                    for k, v in tree.items()}
        return walk(params)

    @property
    def _kw(self) -> dict:
        """The LM functions' mode, QKV rung and mesh keywords."""
        return dict(mode=self.mode, qkv_plan=self.qkv_plan, mesh=self.mesh,
                    data_axes=self.data_axes)

    @property
    def family(self) -> str:
        return self.cfg.family

    def _lm_only(self, what: str) -> None:
        if self.family not in DECODER_FAMILIES:
            _refuse(what, self.family)

    def forward(self, params, batch):
        """logits (B, S, V) fp32. lm: ``batch`` is the (B, S) tokens;
        vlm: {"patch_embeds", "inputs"}, the text positions' logits;
        encdec: {"encoder_embeds", "inputs"}; encoder: {"inputs"} or the
        tokens."""
        if self.family == "vlm":
            return _vlm.vlm_forward(self.cfg, params, batch, mode=self.mode,
                                    qkv_plan=self.qkv_plan)
        if self.family == "encdec":
            return _ed.encdec_forward(self.cfg, params, batch, mode=self.mode,
                                      qkv_plan=self.qkv_plan)
        if self.family == "encoder":
            return _enc.encoder_forward(self.cfg, params, batch,
                                        mode=self.mode,
                                        qkv_plan=self.qkv_plan)
        return _lm.lm_forward(self.cfg, params, batch, **self._kw)

    def loss(self, params, batch):
        """(loss, metrics) of a batch {"inputs", "targets", "loss_mask"}
        (vlm: and "patch_embeds"; encdec: and "encoder_embeds"), the blocks
        recomputed in the backward per ``cfg.remat_policy``: the LM's
        next-token loss, the vlm's on its text positions, the encoder's
        masked-LM loss, the enc-dec's decoder loss."""
        if self.family == "vlm":
            return _vlm.vlm_loss(self.cfg, params, batch, mode=self.mode,
                                 qkv_plan=self.qkv_plan, tp=self.tp)
        if self.family == "encdec":
            return _ed.encdec_loss(self.cfg, params, batch, mode=self.mode,
                                   qkv_plan=self.qkv_plan, tp=self.tp)
        if self.family == "encoder":
            return _enc.encoder_loss(self.cfg, params, batch, mode=self.mode,
                                     qkv_plan=self.qkv_plan, tp=self.tp)
        return _lm.lm_loss(self.cfg, params, batch, **self._kw, tp=self.tp)

    def init_cache(self, batch: int, max_len: int) -> dict:
        if self.family == "encdec":
            return _ed.encdec_init_cache(self.cfg, batch, max_len,
                                         self.device)
        self._lm_only("init_cache")
        return _lm.lm_init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, batch, cache):
        """lm: ``batch`` is the (B, S) prompt tokens; vlm: the tokens or a
        dict whose "inputs" the backbone prefills (text only, as the
        reference's); encdec: {"encoder_embeds", "inputs"}. Fills ``cache``
        in place."""
        if self.family == "encdec":
            return _ed.encdec_prefill(self.cfg, params, batch, cache,
                                      mode=self.mode, qkv_plan=self.qkv_plan)
        self._lm_only("prefill")
        if self.family == "vlm" and isinstance(batch, dict):
            batch = batch["inputs"]
        return _lm.lm_prefill(self.cfg, params, batch, cache, **self._kw)

    def decode_step(self, params, token, cache, pos):
        """pos: a Python int or a one-element int64 tensor on the device."""
        if self.family == "encdec":
            return _ed.encdec_decode_step(self.cfg, params, token, cache, pos,
                                          mode=self.mode,
                                          qkv_plan=self.qkv_plan)
        self._lm_only("decode_step")
        return _lm.lm_decode_step(self.cfg, params, token, cache, pos,
                                  **self._kw)

    # paged decode surface: a shared page pool, per-sequence page tables
    def init_paged_cache(self, batch_slots: int, n_pages: int,
                         page_size: int) -> dict:
        self._lm_only("init_paged_cache")
        return _lm.lm_init_paged_cache(self.cfg, batch_slots, n_pages,
                                       page_size, self.device)

    def prefill_paged(self, params, tokens, cache, page_rows, slot: int,
                      true_len: int):
        self._lm_only("prefill_paged")
        return _lm.lm_prefill_paged(self.cfg, params, tokens, cache,
                                    page_rows, slot, true_len, **self._kw)

    def prefill_paged_chunk(self, params, tokens, cache, page_rows,
                            start: int, last_index: int):
        self._lm_only("prefill_paged_chunk")
        return _lm.lm_prefill_paged_chunk(self.cfg, params, tokens, cache,
                                          page_rows, start, last_index,
                                          **self._kw)

    def decode_step_paged(self, params, token, cache, page_table, lengths):
        """token (B, T): T > 1 is the speculative verify step."""
        self._lm_only("decode_step_paged")
        return _lm.lm_decode_step_paged(self.cfg, params, token, cache,
                                        page_table, lengths, **self._kw)


def make_batch(cfg, batch: int, seq_len: int, *,
               generator: torch.Generator) -> dict:
    """Training inputs drawn from ``generator`` on its device, as the
    reference's ``make_batch`` (``api.py``) draws them from a key:
    'inputs' and 'targets' (B, S) uniform token ids, 'loss_mask' (B, S)
    ones in fp32, and the stub frontends' outputs, standard normal in the
    compute type: for the 'encdec' family 'encoder_embeds' (B,
    encoder_seq, d_model); for the 'vlm' family 'patch_embeds' (B,
    num_patches, d_model), the text then ``seq_len - num_patches`` tokens
    long."""
    dev = generator.device
    out = {}
    stub = {"encdec": ("encoder_embeds", cfg.encoder_seq),
            "vlm": ("patch_embeds", cfg.num_patches)}.get(cfg.family)
    if stub is not None:
        key, n = stub
        out[key] = torch.randn((batch, n, cfg.d_model), generator=generator,
                               device=dev).to(dtype_of(cfg.compute_dtype))
    if cfg.family == "vlm":
        seq_len -= cfg.num_patches
    for key in ("inputs", "targets"):
        out[key] = torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                 generator=generator, device=dev)
    out["loss_mask"] = torch.ones((batch, seq_len), dtype=torch.float32,
                                  device=dev)
    return out


class MadeBatches:
    """An endless stream of :func:`make_batch` batches for ``train_loop``,
    batch ``i`` drawn from a generator seeded with (seed, i), so a restart
    (``load_state_dict({"step": 0})``) replays the same batches, as
    ``data.DataIterator`` does. Over a ``mesh`` every rank draws the global
    batch and keeps its rows of it (its block along 'data' where that
    divides the batch, as ``data.local_rows``)."""

    def __init__(self, cfg, batch: int, seq_len: int, *, seed: int = 0,
                 device=DEFAULT_DEVICE, mesh=None):
        self.cfg, self.batch, self.seq_len, self.seed = cfg, batch, seq_len, seed
        self.device = resolve_device(device)
        self.step = 0
        self.rows = None
        if mesh is not None:
            from repro_torch.data import DataConfig
            from repro_torch.data.pipeline import local_rows

            self.rows = local_rows(DataConfig(vocab_size=cfg.vocab_size,
                                              seq_len=seq_len,
                                              global_batch=batch), mesh)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003 + self.step)
        self.step += 1
        out = make_batch(self.cfg, self.batch, self.seq_len, generator=gen)
        if self.rows is None:
            return out
        return {k: v[self.rows.start:self.rows.stop] for k, v in out.items()}

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])


def build_model(cfg, *, mode: str = "kernel", device=DEFAULT_DEVICE,
                qkv_plan: str = "rope_fused", mesh=None,
                data_axes=("data",)) -> Model:
    """'kernel' runs the hand-written kernels on CUDA tensors (their plain
    versions on CPU tensors); 'reference' runs the plain unfused path.
    ``qkv_plan`` is the rung of the QKV ladder the kernel mode takes
    (``models/attention.py``): 'rope_fused' (RoPE in the q|k GEMM's store;
    what the reference's byte model picks at every llama shape),
    'norm_fused' (the norm-prologue GEMMs, then the RoPE kernel) or
    'unfused' (standalone norm, plain projections, the RoPE kernel); the
    port's counterpart of the decision a measured table pins in the
    reference; or 'auto': the rung ``core.autotune.select_fusion`` picks,
    with the MLP's and the MoE experts' fused or unfused plans following it
    too, as the reference's always do. ``mesh``: a ``DeviceMesh`` over
    which the MoE blocks run
    expert or tensor parallel (``data_axes``: its data-parallel axes), as
    the reference's ``build_model(cfg, mesh=, data_axes=)``. Raises when
    ``device`` is CUDA and no card is present."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    if qkv_plan not in QKV_PLANS:
        raise ValueError(f"unknown qkv_plan {qkv_plan!r}; have {QKV_PLANS}")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r}; the "
                                  f"port runs {FAMILIES}")
    dev = resolve_device(device)
    return Model(cfg=cfg, mode=mode, device=dev,
                 defs=_PARAM_DEFS[cfg.family](cfg), qkv_plan=qkv_plan,
                 mesh=mesh, data_axes=tuple(data_axes))
