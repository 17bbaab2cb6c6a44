"""Models of the port: the stacked causal LM (``pipelined_transformer``)."""
