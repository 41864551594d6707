"""The general entry loops a traffic mix names: each drives one entry of
the program."""
