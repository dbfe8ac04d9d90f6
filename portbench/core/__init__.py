"""The benchmark's own machinery: finding the pieces a cell names, the chip
checks, host spans, the profiler trace and its reduction, the result line."""
