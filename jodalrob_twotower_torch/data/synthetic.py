"""Synthetic two-tower dataset with planted structure (port of
``jodalrob_twotower_tpu/data/synthetic.py``).

Each entity belongs to a latent cluster; positive pairs link same-cluster
entities; numeric features are noisy cluster centroids and categorical ids
are cluster-correlated. The generator draws from numpy in the same order as
the reference, so one seed gives bit-equal stores and pairs in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from jodalrob_twotower_torch.data.feature_store import FeatureStore
from jodalrob_twotower_torch.schema import TwoTowerSchema, tiny_synthetic_schema


@dataclasses.dataclass
class SyntheticDataset:
    schema: TwoTowerSchema
    notice_store: FeatureStore
    company_store: FeatureStore
    # positive pairs as row indices into the two stores, aligned [P, 2]
    pairs: np.ndarray
    # latent cluster assignment (for diagnostics only)
    notice_cluster: np.ndarray
    company_cluster: np.ndarray

    @property
    def num_pairs(self) -> int:
        return self.pairs.shape[0]

    def split(self, test_fraction: float, seed: int = 42):
        """Shuffled train/test split of the pairs."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_pairs)
        n_test = int(round(self.num_pairs * test_fraction))
        return self.pairs[perm[n_test:]], self.pairs[perm[:n_test]]


def _make_side_features(
    rng: np.random.Generator,
    n_rows: int,
    n_clusters: int,
    cluster: np.ndarray,
    schema_side,
    centroids: np.ndarray,
    noise: float,
) -> FeatureStore:
    n_num = schema_side.num_numeric
    n_cat = schema_side.num_categorical
    # numeric: centroid coordinates (cycled to width) + gaussian noise
    reps = -(-n_num // centroids.shape[1]) if n_num else 1
    base = np.tile(centroids, (1, max(reps, 1)))[:, :n_num]
    numeric = base[cluster] + rng.normal(0.0, noise, size=(n_rows, n_num))
    # categorical: each feature k has a random map cluster->id plus flip noise
    cat = np.empty((n_rows, n_cat), dtype=np.int32)
    for k, spec in enumerate(schema_side.categorical):
        vocab = spec.vocab_size
        cluster_to_id = rng.integers(0, vocab, size=n_clusters)
        ids = cluster_to_id[cluster]
        flip = rng.random(n_rows) < 0.1
        ids = np.where(flip, rng.integers(0, vocab, size=n_rows), ids)
        cat[:, k] = ids
    text = None
    if schema_side.text:
        text = {}
        for t in schema_side.text:
            tc = rng.normal(0.0, 1.0, size=(n_clusters, t.embed_dim))
            text[t.name] = (tc[cluster] + rng.normal(0.0, noise, size=(n_rows, t.embed_dim))).astype(
                np.float32
            )
    return FeatureStore.from_columns(
        schema_side,
        numeric=numeric.astype(np.float32),
        categorical=cat,
        text=text,
    )


def make_synthetic_dataset(
    schema: TwoTowerSchema | None = None,
    *,
    n_notices: int = 10_000,
    n_companies: int = 10_000,
    n_pairs: int = 50_000,
    n_clusters: int = 64,
    noise: float = 0.3,
    seed: int = 0,
) -> SyntheticDataset:
    """Generate the planted-cluster synthetic dataset."""
    if schema is None:
        schema = tiny_synthetic_schema()
    rng = np.random.default_rng(seed)
    notice_cluster = rng.integers(0, n_clusters, size=n_notices)
    company_cluster = rng.integers(0, n_clusters, size=n_companies)
    centroid_dim = 8
    centroids = rng.normal(0.0, 1.0, size=(n_clusters, centroid_dim))

    notice_store = _make_side_features(
        rng, n_notices, n_clusters, notice_cluster, schema.notice, centroids, noise
    )
    company_store = _make_side_features(
        rng, n_companies, n_clusters, company_cluster, schema.company, centroids, noise
    )

    # positive pairs: sample a notice, then a company from the same cluster
    by_cluster = [np.flatnonzero(company_cluster == c) for c in range(n_clusters)]
    # guarantee every cluster has at least one company
    for c in range(n_clusters):
        if len(by_cluster[c]) == 0:
            company_cluster[c % n_companies] = c
            by_cluster[c] = np.asarray([c % n_companies])
    counts = np.asarray([len(m) for m in by_cluster])
    offsets = np.concatenate([[0], np.cumsum(counts[:-1])])
    flat_members = np.concatenate(by_cluster)
    n_idx = rng.integers(0, n_notices, size=n_pairs)
    pair_cluster = notice_cluster[n_idx]
    pos = (rng.random(n_pairs) * counts[pair_cluster]).astype(np.int64)
    c_idx = flat_members[offsets[pair_cluster] + pos]
    pairs = np.stack([n_idx, c_idx], axis=1).astype(np.int64)

    return SyntheticDataset(
        schema=schema,
        notice_store=notice_store,
        company_store=company_store,
        pairs=pairs,
        notice_cluster=notice_cluster,
        company_cluster=company_cluster,
    )
