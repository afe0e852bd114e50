"""AdamW with decoupled weight decay and the paper's LR schedule."""
