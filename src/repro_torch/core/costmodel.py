"""Analytic inference cost model (paper §II-B), generalized per family.

The paper derives, for MHA dense transformers with 2-byte params:

  m1    = L (8 dm dh nh + 4 dm df)                      [weight bytes]
  m2_I  = 4 L s' dm * batch                             [prefill KV bytes]
  m2_A  = 4 L n_i dm * x_i (summed)                     [decode KV bytes]
  t_I   = (L*batch/C) (6 s' dm^2 + 4 s'^2 dm + 2 s' dm^2 + 4 s' dm df)
  t_A   = (L/C) sum_i (n_i-1)(6 dm^2 + 4(s'+n_i/2) dm + 2 dm^2 + 4 dm df)

``CostModel`` reproduces these exactly for MHA dense archs (kv=nh) and
generalizes to GQA / MoE / SSM / hybrid / enc-dec (DESIGN.md §4):
  * GQA: K/V projections & cache scale by nkv/nh;
  * MoE: FFN terms use top_k active experts (+ router), weights count all;
  * SSM/xLSTM: O(1)-in-context state instead of KV cache; decode FLOPs have
    no (s' + n/2) attention-read term => latency constraint becomes linear;
  * SWA: attention reads min(context, window); KV cache capped at window;
  * enc-dec: prefill includes the encoder pass; cross-attn KV is static.

All byte quantities are *pre-quantization* (2-byte params), matching the
paper; quantization enters via alpha/beta in problem.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.config import ModelConfig

PARAM_BYTES = 2.0


@dataclass(frozen=True)
class CostModel:
    cfg: ModelConfig
    paper_faithful: bool = False   # force the paper's MHA equations

    # -- memory ------------------------------------------------------------

    def weight_bytes(self) -> float:
        """m1.  Paper form for MHA dense; param_count elsewhere."""
        c = self.cfg
        if self._mha_dense():
            return c.n_layers * (8 * c.d_model * c.d_head * c.n_heads
                                 + 4 * c.d_model * c.d_ff) * (PARAM_BYTES / 2)
        return c.param_count() * PARAM_BYTES

    def _kv_bytes_per_token(self) -> float:
        """K+V bytes per token per layer stack (GQA-aware)."""
        c = self.cfg
        if c.family == "ssm":
            return 0.0
        if c.family == "hybrid":
            # only the shared-attn sites cache KV
            n_sites = c.n_layers // c.hybrid.attn_every
            return 2 * PARAM_BYTES * n_sites * c.n_kv_heads * c.d_head
        return 2 * PARAM_BYTES * c.n_layers * c.n_kv_heads * c.d_head

    def state_bytes(self) -> float:
        """O(1) recurrent state per sequence (SSM/hybrid; 0 otherwise)."""
        c = self.cfg
        if c.family == "ssm" and c.xlstm is not None:
            d_in = int(c.xlstm.proj_factor_mlstm * c.d_model)
            dh = d_in // c.n_heads
            per_mlstm = c.n_heads * dh * dh * 4          # f32 C matrix
            return c.n_layers * per_mlstm
        if c.family in ("ssm", "hybrid"):
            d_inner = c.ssm.expand * c.d_model
            H = d_inner // c.ssm.head_dim
            return c.n_layers * H * c.ssm.head_dim * c.ssm.d_state * 4
        return 0.0

    def _ctx(self, length: int) -> float:
        """Effective cached context (window-capped)."""
        w = self.cfg.sliding_window
        return float(min(length, w)) if w else float(length)

    def kv_bytes_prefill(self, s: int, batch: int) -> float:
        """m2_I for ``batch`` prompts of padded length s."""
        return (self._kv_bytes_per_token() * self._ctx(s)
                + self.state_bytes()) * batch

    def kv_bytes_decode(self, ns: Sequence[int], s: int = 0) -> float:
        """m2_A: additional KV for each request's n_i output tokens.

        With a sliding window the cache is a rolling buffer of capacity W,
        so decode only grows it by the slots not already used by the prompt.
        """
        per_tok = self._kv_bytes_per_token()
        w = self.cfg.sliding_window
        if w:
            return sum(per_tok * max(0, min(s + n, w) - min(s, w))
                       for n in ns)
        return sum(per_tok * n for n in ns)

    # -- FLOPs / latency -----------------------------------------------------

    def _ffn_flops_per_token(self) -> float:
        c = self.cfg
        if c.family == "ssm":
            return 0.0
        n_mats = 3 if c.act == "silu" else 2
        per = n_mats * 2 * c.d_model * c.d_ff
        if c.is_moe:
            return c.moe.top_k * per + 2 * c.d_model * c.moe.n_experts
        return per

    def _qkvo_flops_per_token(self) -> float:
        c = self.cfg
        q = 2 * c.d_model * c.n_heads * c.d_head
        kv = 2 * 2 * c.d_model * c.n_kv_heads * c.d_head
        o = 2 * c.n_heads * c.d_head * c.d_model
        return q + kv + o

    def _attn_read_flops(self, ctx: float) -> float:
        """QK^T + PV per token at context ``ctx``."""
        c = self.cfg
        return 4 * self._ctx(ctx) * c.n_heads * c.d_head

    def _ssm_flops_per_token(self) -> float:
        c = self.cfg
        if c.family == "ssm" and c.xlstm is not None:
            d_in = int(c.xlstm.proj_factor_mlstm * c.d_model)
            dh = d_in // c.n_heads
            proj = 2 * (2 * c.d_model * d_in + d_in * c.d_model
                        + 3 * d_in * d_in)
            cell = 2 * c.n_heads * dh * dh * 2           # C update + read
            return proj + cell
        d_inner = c.ssm.expand * c.d_model
        H = d_inner // c.ssm.head_dim
        proj = 2 * (c.d_model * (2 * d_inner + 2 * c.ssm.d_state + H)
                    + d_inner * c.d_model)
        cell = 2 * H * c.ssm.head_dim * c.ssm.d_state * 2
        return proj + cell

    def _layer_flops_per_token(self, ctx: float) -> float:
        """One decoder layer, one token, at effective context ctx."""
        c = self.cfg
        if c.family == "ssm":
            return self._ssm_flops_per_token()
        if c.family == "hybrid":
            # per *average* layer: mamba every layer + shared attn at sites
            site_frac = (c.n_layers // c.hybrid.attn_every) / c.n_layers
            attn = (self._qkvo_flops_per_token()
                    + self._attn_read_flops(min(ctx, 4096))
                    + self._ffn_flops_per_token())
            return self._ssm_flops_per_token() + site_frac * attn
        return (self._qkvo_flops_per_token() + self._attn_read_flops(ctx)
                + self._ffn_flops_per_token())

    def prefill_flops(self, s: int, batch: int) -> float:
        """Total FLOPs of the Initial Stage for a batch of padded length s."""
        c = self.cfg
        if self._mha_dense():
            dm, df, L = c.d_model, c.d_ff, c.n_layers
            per_prompt = L * (6 * s * dm * dm + 4 * s * s * dm
                              + 2 * s * dm * dm + 4 * s * dm * df)
            return per_prompt * batch
        # general: sum over positions of per-token cost at causal context
        if c.family == "ssm":
            per_prompt = c.n_layers * s * self._ssm_flops_per_token()
        else:
            avg_ctx = (s + 1) / 2.0
            per_prompt = c.n_layers * s * self._layer_flops_per_token(avg_ctx)
        if c.family == "audio":
            F = c.encdec.n_audio_frames
            enc = c.encdec.n_enc_layers * F * (
                self._qkvo_flops_per_token() + self._attn_read_flops(F)
                + self._ffn_flops_per_token())
            cross = c.n_layers * s * (self._qkvo_flops_per_token()
                                      + self._attn_read_flops(F))
            per_prompt += enc + cross
        return per_prompt * batch

    def decode_flops(self, s: int, ns: Sequence[int]) -> float:
        """Total FLOPs of the Auto-regressive Stage (paper's t_A * C)."""
        c = self.cfg
        total = 0.0
        for n in ns:
            iters = max(n - 1, 0)
            if self._mha_dense():
                dm, df, L = c.d_model, c.d_ff, c.n_layers
                total += L * iters * (6 * dm * dm + 4 * (s + n / 2.0) * dm
                                      + 2 * dm * dm + 4 * dm * df)
            else:
                avg_ctx = s + n / 2.0
                per_tok = c.n_layers * self._layer_flops_per_token(avg_ctx)
                if c.family == "audio":
                    per_tok += c.n_layers * (
                        self._qkvo_flops_per_token()
                        + self._attn_read_flops(c.encdec.n_audio_frames))
                total += iters * per_tok
        return total

    def t_prefill(self, s: int, batch: int, C: float) -> float:
        return self.prefill_flops(s, batch) / C

    def t_decode(self, s: int, ns: Sequence[int], C: float) -> float:
        return self.decode_flops(s, ns) / C

    # -- helpers -------------------------------------------------------------

    def _mha_dense(self) -> bool:
        c = self.cfg
        return (self.paper_faithful or
                (c.family == "dense" and c.n_kv_heads == c.n_heads
                 and c.act != "silu" and not c.sliding_window))

    def latency_is_quadratic(self) -> bool:
        """Whether t_A grows ~ n^2 (attention read over growing context)."""
        return self.cfg.family not in ("ssm",) and not self.cfg.sliding_window
