"""The protocol layer: state, coins, validation, adversary, delivery, round body."""
