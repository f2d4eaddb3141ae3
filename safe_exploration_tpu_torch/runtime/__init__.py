"""L4 experiment runtime: configuration and wiring."""
