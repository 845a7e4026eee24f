"""Generator of the benchmark's annotation and samples."""
