"""The benchmark's harness: one cell's set-up, window, trace, check and
result line (``cell.run``), and the yardstick it measures with."""
