"""The mesh of the port: a process group with one process per device
(``mesh.py``), its launcher (``distributed.py``), the embedding lookups of
replicated and row-sharded tables (``sharded_embedding.py``), row-sharded
feature stores (``sharded_store.py``), the mesh train steps
(``sharded_train.py``), the sparse-table mesh (``sharded_sparse.py``) and
the compressed gradient sync (``compressed_grads.py``).

The compressed sync's entry points are exported here, as the reference's
package exports them. They load on first use: the towers import
``parallel.mesh``, and the steps import the towers."""

_COMPRESSED = ("compressed_psum_tree", "make_dp_compressed_indexed_train", "make_dp_compressed_train_step")


def __getattr__(name: str):
    if name in _COMPRESSED:
        from jodalrob_twotower_torch.parallel import compressed_grads

        return getattr(compressed_grads, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
