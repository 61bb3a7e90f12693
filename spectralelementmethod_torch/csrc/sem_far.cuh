// The far roll classes of a split DSS as a by-value kernel operand, shared
// by the far update (far_update.cu) and kernel B's far mode
// (cg_kernel_b.cu).  The host builds one per far plan (ops/kernels.py
// far_tables) and passes it as a kernel parameter, so it sits in the
// constant bank and no loop reads an entry from device memory.
#pragma once

namespace sem {

// the most far entries (and destination rows) a plan may have
constexpr int kFarMaxEntries = 128;

// The destination rows with far entries, and their entries in class order
// (row r's are first[r] .. first[r + 1]).
struct FarTables {
  int n_rows;
  unsigned char dst[kFarMaxEntries];        // row r's destination row
  unsigned char first[kFarMaxEntries + 1];  // row r's first entry
  unsigned char src[kFarMaxEntries];        // entry's source row
  unsigned char mask[kFarMaxEntries];       // entry's class mask
  int delta[kFarMaxEntries];                // entry's element offset
};

}  // namespace sem
