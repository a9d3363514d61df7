"""CFFM model for the port."""
