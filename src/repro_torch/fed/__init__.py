"""Federation runtime of the port: the communication ledger and the
one-shot round loop."""
