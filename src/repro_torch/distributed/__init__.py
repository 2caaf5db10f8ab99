"""One-device counterparts of `repro.distributed`: the fault loop
(`fault`, a verbatim copy, pinned by tests/test_torch_substrate.py) and the
gradient compressors (`compression`).  The mesh, sharding and elastic
modules describe multi-chip TPU meshes and are not ported."""
