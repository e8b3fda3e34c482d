// K5's runtime-r path at bmax 8 and 16 (more than 4 extra rows, or forced),
// built from stagewise.cu as a library of its own so that nvcc compiles
// it beside the other parts (PHC_SW_PART there).
#define PHC_SW_PART 2
#include "stagewise.cu"
