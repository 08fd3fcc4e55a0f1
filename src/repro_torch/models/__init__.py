"""Model code of the port: blocks and the decoder forward."""
