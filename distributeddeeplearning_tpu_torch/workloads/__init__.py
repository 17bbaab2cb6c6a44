"""Workloads of the port: the causal-LM trainer (``transformer``), BERT
fine-tuning (``bert``), the synthetic image benchmark (``benchmark``) and
ImageNet classification from records or images (``imagenet``), with the
keyword-flag runner (``_runner``)."""
