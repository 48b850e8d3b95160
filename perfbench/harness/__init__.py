"""The benchmark's harness: cells, traffic, weights, work counts, trace, comparison."""
