"""The benchmark's yardstick for roofline shares: the data-sheet peaks, the
frozen per-unit operation and byte counts, and each kernel's work reckoned
from the cell's inputs."""
