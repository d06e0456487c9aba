"""FedGenGMM core of the port: GMM primitives, EM, k-means, one-shot
federated aggregation."""
