"""Selection, rates, aggregation and the federated round of the port."""
