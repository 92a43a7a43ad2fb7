"""The LM substrate of the port: parameters, layers and the loss, flash
attention with its backward, the six families (dense, moe and vlm on the
transformer; ssm, hybrid, encdec) and the family dispatcher."""
