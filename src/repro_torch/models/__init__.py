"""The LM substrate of the port, forward only: parameters, layers, the
blocked flash forward, the dense transformer and the family dispatcher."""
