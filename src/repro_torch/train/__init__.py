"""Training steps, trainer loop, fault tolerance."""
