"""The plain references and the inputs both sides are handed."""
