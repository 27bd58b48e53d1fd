"""The harness's general parts: manifest lookup, statistics, device facts,
the trace's reduction, images, params, the comparison and the result line."""
