"""Problem configurations of the paper's benchmarks."""
