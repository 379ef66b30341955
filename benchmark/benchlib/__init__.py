"""The benchmark's machinery: the closed-loop generator, the trace reader, the
frozen operation counts and peaks, and the harness that runs one cell."""
