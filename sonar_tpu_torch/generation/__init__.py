"""Generation: beam search over the conditional text decoder."""
