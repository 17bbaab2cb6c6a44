"""Workloads of the port: the causal-LM trainer (``transformer``), BERT
fine-tuning (``bert``) and the synthetic image benchmark (``benchmark``),
with the keyword-flag runner (``_runner``)."""
