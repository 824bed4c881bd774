"""The benchmark's general machinery: the manifest, the one traffic
generator, the timed window, the trace and the comparison's plumbing."""
