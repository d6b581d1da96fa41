"""Synthetic token corpus with domain structure, for LM training.

The corpus is organized exactly like the paper's datasets: tuples are
(domain_id = Z, token-bucket = X) pairs living in blocks of a shuffled
layout. Domains are synthetic "sources" (web, code, forums, ...) with
distinct token-class distributions; some domains are planted close to a
reference distribution — the ground truth the FastMatch selector should
recover. Tokens themselves are drawn per-domain from a power-law over
the vocab, bucketed into X = token_id % num_buckets classes for the
histogram layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synth import perturb_distribution

__all__ = ["CorpusSpec", "TokenCorpus", "make_corpus"]


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    num_domains: int = 64
    num_buckets: int = 128  # |V_X| for the matching layer
    vocab_size: int = 50304
    block_tokens: int = 2048  # tokens per corpus block
    num_blocks: int = 4096
    n_reference: int = 8  # domains planted near the reference mix
    close_distance: float = 0.03
    far_distance: float = 0.35
    reference_alpha: float = 4.0  # dirichlet concentration of the target mix
    domain_alpha: float = 0.7  # concentration of non-reference domains
    seed: int = 0


@dataclasses.dataclass
class TokenCorpus:
    spec: CorpusSpec
    tokens: np.ndarray  # (num_blocks, block_tokens) int32
    domains: np.ndarray  # (num_blocks,) int32 — domain of each block
    reference: np.ndarray  # (num_buckets,) f64 — the target bucket mix
    domain_bucket_dists: np.ndarray  # (num_domains, num_buckets)
    close_ids: np.ndarray

    @property
    def true_dists(self) -> np.ndarray:
        return np.abs(self.domain_bucket_dists - self.reference[None, :]).sum(axis=1)

    def bucket_of(self, tokens: np.ndarray) -> np.ndarray:
        return tokens % self.spec.num_buckets


def make_corpus(spec: CorpusSpec) -> TokenCorpus:
    rng = np.random.default_rng(spec.seed)
    nb, bt, vd = spec.num_blocks, spec.block_tokens, spec.num_domains

    # Reference bucket mix (e.g. the "high-quality corpus" token profile).
    reference = rng.dirichlet(np.full(spec.num_buckets, spec.reference_alpha))

    # Per-domain bucket distributions.
    dists = np.zeros((vd, spec.num_buckets))
    close_ids = rng.choice(vd, size=spec.n_reference, replace=False)
    close_set = set(close_ids.tolist())
    for d in range(vd):
        if d in close_set:
            dists[d] = perturb_distribution(
                reference, spec.close_distance * rng.uniform(0.5, 1.5), rng
            )
        else:
            for _ in range(64):
                h = rng.dirichlet(np.full(spec.num_buckets, spec.domain_alpha))
                if np.abs(h - reference).sum() >= spec.far_distance:
                    break
            dists[d] = h

    # Blocks: each block belongs to one domain (documents cluster in
    # storage); block order is shuffled (Challenge 1 layout).
    domains = rng.integers(0, vd, size=nb).astype(np.int32)
    tokens = np.empty((nb, bt), dtype=np.int32)
    n_rep = spec.vocab_size // spec.num_buckets
    for b in range(nb):
        # sample buckets, then a token within the bucket (token = bucket + k*B)
        buckets = rng.choice(spec.num_buckets, size=bt, p=dists[domains[b]])
        offsets = rng.integers(0, n_rep, size=bt)
        tokens[b] = buckets + offsets * spec.num_buckets

    return TokenCorpus(
        spec=spec,
        tokens=tokens,
        domains=domains,
        reference=reference,
        domain_bucket_dists=dists,
        close_ids=np.sort(close_ids),
    )
