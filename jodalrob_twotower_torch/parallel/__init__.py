"""The data-parallel mesh of the port: a process group with one process per
device (``mesh.py``), its launcher (``distributed.py``), the embedding lookup
of replicated tables (``sharded_embedding.py``) and the mesh train steps
(``sharded_train.py``)."""
