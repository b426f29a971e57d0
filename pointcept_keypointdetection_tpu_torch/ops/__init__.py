"""Point-cloud ops of the PyTorch port: codes, serialization, pooling maps, sparse conv, attention."""
