"""The port's baseline decoder, used as an oracle."""
