"""The nn layers of the port (`nn.Layer` subclasses)."""
