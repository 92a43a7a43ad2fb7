"""The LM substrate of the port, forward only: parameters, layers, the
blocked flash forward, the six families (dense, moe and vlm on the
transformer; ssm, hybrid, encdec) and the family dispatcher."""
