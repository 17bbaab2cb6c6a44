"""int8 quantization of the port: the KV-cache part of ``quant/qtensor.py``."""
