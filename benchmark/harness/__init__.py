"""The benchmark's harness: the manifest and the files it names, the
traffic generator, seeded weights, the drivers of each kind of traffic,
the trace reader, the operation and byte counts, and the output check."""
