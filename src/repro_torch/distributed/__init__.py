"""One-device counterparts of `repro.distributed`: the fault loop
(`fault`, a verbatim copy, pinned by tests/test_torch_substrate.py), the
gradient compressors (`compression`), the sharding rules (`sharding`:
specs computed for any mesh, trees placed on one device) and elastic
resharding (`elastic`)."""
