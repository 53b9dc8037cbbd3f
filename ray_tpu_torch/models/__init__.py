"""Model family: the decoder-only transformer and its paged decode path."""
