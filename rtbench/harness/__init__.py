"""The benchmark's harness: registry of named files, the frame path, the
measured and traced windows, the rooflines' yardstick and the check."""
