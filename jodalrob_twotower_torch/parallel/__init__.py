"""The mesh of the port: a process group with one process per device
(``mesh.py``), its launcher (``distributed.py``), the embedding lookups of
replicated and row-sharded tables (``sharded_embedding.py``), row-sharded
feature stores (``sharded_store.py``), the mesh train steps
(``sharded_train.py``) and the sparse-table mesh (``sharded_sparse.py``)."""
