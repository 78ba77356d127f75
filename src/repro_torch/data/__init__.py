"""Data substrate: synthetic TIDIGITS-like / SensorsGas-like generators
(nothing is downloaded)."""
