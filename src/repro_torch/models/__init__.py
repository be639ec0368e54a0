"""The model: layers, attention and the decoder for serving."""
