"""Post-quantum schemes on the port's banks kernels: batched ML-KEM-768
(``pq.mlkem``)."""
