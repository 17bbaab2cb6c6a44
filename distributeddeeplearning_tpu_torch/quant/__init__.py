"""int8 quantization of the port: int8 weights and KV pages
(``qtensor``) and post-training weight quantization (``calibrate``)."""
