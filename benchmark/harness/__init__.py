"""The benchmark's general machinery: cells, data, loops, trace, checks."""
