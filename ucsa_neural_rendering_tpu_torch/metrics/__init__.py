from .meter import (SemanticsMeter, confusion_matrix_update,
                    measure_from_confmat)

__all__ = ["SemanticsMeter", "confusion_matrix_update",
           "measure_from_confmat"]
