"""Traffic drivers, one file per kind, found by the name a cell gives."""
