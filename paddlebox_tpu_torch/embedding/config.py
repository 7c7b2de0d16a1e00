"""Embedding-engine configuration and row layout.

The reference's per-feature value struct (``FeaturePullValueGpu`` /
``FeaturePushValueGpu``, used by box_wrapper_impl.h:122-245) carries
``show, clk, embed_w`` (a scalar logit weight — the "wide"/LR component) plus
an ``embedx`` vector, with optimizer state held inside the parameter server.
We keep that layout, as one flat float32 row per feature:

    col 0            show      (impression counter, drives CVM + shrink)
    col 1            clk       (click counter)
    cols 2..2+n_w    embed_w   (scalar weight block; n_w = embed_w_num,
                                > 1 for the ShareEmbedding feature type)
    then  ..+dim     embedx    (embedding vector)
    tail             optimizer state (per `optimizer`)

Pull (what a lookup returns to the model) = cols [0, fixed_cols + dim) —
show, clk, w-block, embedx; matching the reference's pull value. Push =
(d_w-block, d_embedx) grads plus show/clk increments, applied *inside the
table* like the reference's PS-side optimizer (box_wrapper_impl.h:229
"optimizer update inside the PS").

Supported embedx dims mirror the reference's dispatch envelope
(box_wrapper.cc:444-461): any dim works here (no template dispatch), the
constant list is kept only for config validation parity.
"""

from __future__ import annotations

import dataclasses

REFERENCE_EMBEDX_DIMS = (0, 2, 4, 8, 16, 32, 64, 128, 256, 280)

# optimizer → number of state columns
_OPT_SLOTS = {
    "sgd": 0,
    "adagrad": 2,       # w_g2sum, x_g2sum (per-feature scalar, CTR practice)
    "ftrl": 3,          # w_z, w_n (FTRL on w) + x_g2sum (adagrad on embedx)
    "adam": 4,          # w_m, w_v, x_m, x_v (per-feature scalar moments)
}


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    dim: int = 8                      # embedx dimension
    expand_dim: int = 0               # expand embedding (pull_box_extended_sparse)
    optimizer: str = "adagrad"
    learning_rate: float = 0.05
    initial_g2sum: float = 3.0        # adagrad epsilon-like accumulator floor
    initial_range: float = 0.02       # init scale for new embedx rows
    beta1: float = 0.9                # adam
    beta2: float = 0.999
    ftrl_l1: float = 1.0
    ftrl_l2: float = 1.0
    ftrl_beta: float = 1.0
    # Variable/NNCross feature types (FeatureVarPullValueGpu /
    # PullCopy*NNCross, box_wrapper.cu:161-260): each key's embedx — and,
    # separately, its expand plane — exists only once the key has enough
    # shows; absent planes pull as zeros and receive no grads. The
    # reference's per-key `embedding_size`/`embed_expand_size` presence
    # flags (total_dims bits, box_wrapper.cu:182-184) become show-threshold
    # masks over fixed-shape rows — the static-shape rendering of a
    # variable-length row. 0 = plane always present (the base feature type).
    mf_create_threshold: float = 0.0
    expand_create_threshold: float = 0.0
    # ShareEmbedding feature type (FeaturePullValueGpuShareEmbedding,
    # box_wrapper.cc:419-422; PushCopyBaseShareEmbedding box_wrapper.cu:543):
    # several slots share one key space, the row carries one scalar embed
    # weight PER SHARING SLOT (embed_g[SHARE_EMBEDDING_NUM]) plus the common
    # embedx. Here: the w column becomes a block of `embed_w_num` columns;
    # ops/share_embedding.py selects each slot's plane from the pull.
    embed_w_num: int = 1
    seed: int = 0
    # Device working-set storage for the embedx plane: "f32" (exact) or
    # "int16"/"int8" (quantized with a per-row scale — the reference's
    # Quant/ShowClk feature types, box_wrapper.cu pull variants; see
    # embedding/quant.py). The HOST store stays f32 either way.
    storage: str = "f32"

    def __post_init__(self) -> None:
        if self.optimizer not in _OPT_SLOTS:
            raise ValueError(f"unknown embedding optimizer {self.optimizer!r}; "
                             f"choose from {sorted(_OPT_SLOTS)}")
        if self.dim < 0 or self.expand_dim < 0:
            raise ValueError("dim/expand_dim must be >= 0")
        if self.storage not in ("f32", "int16", "int8"):
            raise ValueError(f"storage must be f32|int16|int8, "
                             f"got {self.storage!r}")
        if self.embed_w_num < 1:
            raise ValueError("embed_w_num must be >= 1")
        if self.embed_w_num > 1 and self.optimizer == "ftrl":
            raise ValueError(
                "share-embedding (embed_w_num > 1) is not supported with the "
                "ftrl optimizer: FTRL's z/n state is per-feature scalar and "
                "cannot serve a w block; use sgd/adagrad/adam")
        if self.mf_create_threshold < 0 or self.expand_create_threshold < 0:
            raise ValueError("create thresholds must be >= 0")
        if self.expand_create_threshold > 0 and not self.expand_dim:
            raise ValueError(
                "expand_create_threshold needs expand_dim > 0")

    # --- row geometry ---
    @property
    def total_dim(self) -> int:
        """embedx + expand columns — one contiguous trained vector.

        The reference stores the expand embedding in the same per-feature
        value struct ({EmbedxDim, ExpandDim} templates, box_wrapper.cc:444-461)
        and trains both with the PS-side optimizer; here the split point is
        config metadata and ops/extended.py slices the pulled vector.
        """
        return self.dim + self.expand_dim

    @property
    def n_opt_slots(self) -> int:
        return _OPT_SLOTS[self.optimizer]

    @property
    def fixed_cols(self) -> int:
        """show, clk, w-block — the columns before embedx."""
        return 2 + self.embed_w_num

    @property
    def pull_width(self) -> int:
        """show, clk, w-block, embedx(+expand) — what lookup returns."""
        return self.fixed_cols + self.total_dim

    @property
    def grad_width(self) -> int:
        """d_w-block, d_embedx(+expand) — what push consumes."""
        return self.embed_w_num + self.total_dim

    @property
    def row_width(self) -> int:
        return self.fixed_cols + self.total_dim + self.n_opt_slots

    # column helpers
    SHOW, CLK, W = 0, 1, 2

    @property
    def w_cols(self) -> slice:
        return slice(2, self.fixed_cols)

    @property
    def embedx_cols(self) -> slice:
        return slice(self.fixed_cols, self.fixed_cols + self.total_dim)

    @property
    def opt_cols(self) -> slice:
        return slice(self.fixed_cols + self.total_dim, self.row_width)
