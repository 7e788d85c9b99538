"""Entry points of the port: train steps and the CLI trainer."""
