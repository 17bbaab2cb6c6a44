"""Attention ops of the port: each CUDA kernel beside its plain version.

``ops.flash_attention`` (prefill) and ``ops.flash_decode`` (decode) are
imported as modules — their ``launches`` counters live there — so this
package re-exports nothing that would shadow them.
"""
