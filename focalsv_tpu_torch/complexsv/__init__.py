"""Complex SV calling (TRA/INV/DUP), auto and target modes."""
