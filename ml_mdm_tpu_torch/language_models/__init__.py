"""The text tower of the port: tokenizer, T5 encoder and the factory that
builds them from the arguments."""
