"""The benchmark's general parts: the manifest, the traffic generator, the
closed loop, the trace reader and the comparison with the reference."""
