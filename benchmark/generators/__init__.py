"""Traffic generators: one module per kind of record stream, named by a
traffic mix's `generator` key. Each exposes `Stream(mix, seed, device)`."""
