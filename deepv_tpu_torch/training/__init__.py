"""Training of the MMDiT: flow-matching objectives and the Trainer."""
