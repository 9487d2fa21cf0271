"""Deterministic, restart-safe synthetic data pipeline (a copy of
``repro/data/pipeline.py``, which is numpy only: the same seeds give the
same bytes).

Every batch is a pure function of (seed, step): after a preemption or
elastic reshape the pipeline resumes from the checkpointed step index with
bit-identical data — no iterator state to persist.  Per-host sharding
slices the global batch by (process_index, process_count), so each host
materializes only its shard (the pattern a real multi-host loader uses).

Tokens are Zipf-ish categorical draws (uniform over a vocab-sized range
biased toward low ids) — enough structure for loss to move while staying
dependency-free.  Labels are next-token targets with the final position
masked (-1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # modality stubs (assignment: frontends provide precomputed embeddings)
    image_tokens: int = 0
    frame_len: int = 0
    d_model: int = 0


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig, *, process_index: int = 0,
                 process_count: int = 1):
        assert cfg.global_batch % process_count == 0
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = cfg.global_batch // process_count

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, step, self.process_index))

    def batch_at(self, step: int) -> dict:
        """The batch for ``step`` (host-local shard)."""
        cfg = self.cfg
        rng = self._rng(step)
        # zipf-biased ids, clipped into vocab
        raw = rng.zipf(1.3, size=(self.local_batch, cfg.seq_len + 1))
        tokens_full = np.minimum(raw - 1, cfg.vocab_size - 1).astype(np.int32)
        tokens = tokens_full[:, :-1]
        labels = tokens_full[:, 1:].copy()
        labels[:, -1] = -1
        out = {"tokens": tokens, "labels": labels}
        if cfg.image_tokens:
            out["image_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.image_tokens, cfg.d_model)
            ).astype(np.float32) * 0.02
        if cfg.frame_len:
            out["encoder_frames"] = rng.standard_normal(
                (self.local_batch, cfg.frame_len, cfg.d_model)
            ).astype(np.float32) * 0.02
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def pipeline_for(cfg_model, shape, *, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
    """Pipeline matching a (ModelConfig, ShapeConfig) cell."""
    dc = DataConfig(
        vocab_size=cfg_model.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        image_tokens=cfg_model.num_image_tokens,
        frame_len=(shape.seq_len // cfg_model.audio_downsample
                   if cfg_model.encoder_segments else 0),
        d_model=(cfg_model.d_model
                 if (cfg_model.num_image_tokens or cfg_model.encoder_segments)
                 else 0),
    )
    return SyntheticPipeline(dc, process_index=process_index,
                             process_count=process_count)
