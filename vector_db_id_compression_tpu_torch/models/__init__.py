"""Neural models: the QINCo residual quantizer for large-scale re-ranking."""
