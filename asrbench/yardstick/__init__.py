"""Traffic, weights, operation and byte counts, and trace reduction."""
